// Mamba-2 SSD (state-space duality) chunked scan for Hopper (sm_90a),
// plain C interface.
//
// Replaces the TPU kernel repro/kernels/ssd.py::_body (called through
// ssd_scan): y = SSD(x, dt, A, B, C) over chunks of CH tokens, the D skip
// left to the caller.  x (Bt, S, H, P) and y in f32 or bf16; dt (Bt, S, H)
// and A (H,) in f32; B and C (Bt, S, 1, N), shared by every head.  Each is
// read or written through its strides, so the views the model cuts from
// its conv output (x, B and C side by side in one row) need no copy.
//
// What bounds it on an H100: per chunk of c tokens a head does the lower
// triangle of C Bᵀ (c(c+1)/2 dots of length N), the triangle of the scores
// times x (c(c+1)/2 x P), C @ h and the state update (2 x c N P
// multiply-adds each).  At mamba2-780m's chunk 128, N 128, P 64 that is
// about 7.4 MFLOP a chunk against 24 KB of f32 x and y and 1 KB of dt per
// head, plus 128 KB of B and C shared by all 48 heads: some 100 flops a
// byte, past the f32 ridge of 67 / 3.35 = 20, so the card's bound is its
// f32 operations (67 TFLOP/s on the CUDA cores; the TPU kernel's dots are
// f32 too).  What the design does about that: every operand of a chunk is
// staged once in shared memory in f32, and the inner loops read it with
// 16-byte loads into small register tiles (a 2 x 4 or 4 x 1 block of
// outputs a thread), so a multiply-add costs well under one shared-memory
// load; only the lower triangle of the scores is ever formed.  Tensor
// cores (TF32 or bf16 wgmma) and a faster schedule are later work.
//
// Design (one block of NT = 256 threads per (head, batch row); grid
// (H, Bt)):
//   * the TPU kernel's sequential chunk axis, whose (N, P) state it carried
//     in VMEM scratch across grid steps, becomes a loop inside the block:
//     the block walks its head's chunks in order with h in shared memory,
//     in f32, for the whole loop (nothing carries between blocks on a GPU);
//   * per chunk: x, B, C and dt are staged in f32, zero-filled past S, so
//     dt and dt*A are 0 there and the state does not move (the TPU kernel
//     padded in its wrapper and masked with a where); thread 0 takes the
//     inclusive cumsum of dt*A in f32, in order;
//   * the scores (C Bᵀ ⊙ L ⊙ dt) are formed a row tile of RT = 32 rows at
//     a time, only for s <= t: L = exp(cum_t - cum_s) would overflow to inf
//     above the diagonal, where the TPU kernel computed it and selected it
//     away; here it is never computed;
//   * y rows = scores @ x + exp(cum_t) (C_t @ h), stored in x's dtype, only
//     for rows t < S; then B is scaled in place by w = dt exp(total - cum)
//     (the TPU kernel's w, with the same rounding) and h <- exp(total) h +
//     wᵀ @ x.
// Shared memory, in floats: x CH P, B and C CH (N + 4) each (rows padded
// for conflict-free 16-byte loads), h N P, four CH-vectors and the score
// tile RT (CH + 1): 219,264 bytes at CH 128, N 128, P 64, so every launch
// opts in to dynamic shared memory above 48 KB (one block an SM).
// Instances: CH in {16, 32, 64, 128} x {f32, bf16}; N and P are run-time
// values, multiples of 4, N <= 128 and P <= 64.
//
// Built by repro_torch/kernels/build.py as one nvcc job into the same
// library as the GEMM kernels.

#include "tile.cuh"

namespace {

using iaat::narrow;
using iaat::widen;

constexpr int NT = 256;       // threads per block
constexpr int NMAX = 128;     // largest state width
constexpr int PMAX = 64;      // largest head width
constexpr int PAD = 4;        // floats of padding on a B or C row

__host__ __device__ constexpr int rows_of(int CH) { return CH < 32 ? CH : 32; }

// floats of dynamic shared memory for one block
__host__ __device__ constexpr size_t smem_floats(int CH, int N, int P) {
  return (size_t)CH * P + 2 * (size_t)CH * (N + PAD) + (size_t)N * P +
         4 * (size_t)CH + (size_t)rows_of(CH) * (CH + 1);
}

__device__ __forceinline__ void fma4(float4& acc, float s, const float4& v) {
  acc.x = fmaf(s, v.x, acc.x);
  acc.y = fmaf(s, v.y, acc.y);
  acc.z = fmaf(s, v.z, acc.z);
  acc.w = fmaf(s, v.w, acc.w);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <typename T, int CH>
__global__ void __launch_bounds__(NT)
ssd_scan_kernel(const T* __restrict__ x, int64_t x_sb, int64_t x_ss,
                int64_t x_sh, int64_t x_sp,
                const float* __restrict__ dt, int64_t dt_sb, int64_t dt_ss,
                int64_t dt_sh, const float* __restrict__ A,
                const T* __restrict__ Bm, int64_t b_sb, int64_t b_ss,
                int64_t b_sn,
                const T* __restrict__ Cm, int64_t c_sb, int64_t c_ss,
                int64_t c_sn,
                T* __restrict__ y, int64_t y_sb, int64_t y_ss, int64_t y_sh,
                int64_t y_sp, int S, int N, int P) {
  constexpr int RT = rows_of(CH);    // score rows per tile
  constexpr int LDS = CH + 1;        // score tile row stride
  extern __shared__ __align__(16) float sm[];
  const int LDN = N + PAD;
  float* xs = sm;                    // [CH][P]
  float* bs = xs + CH * P;           // [CH][LDN]
  float* cs = bs + CH * LDN;         // [CH][LDN]
  float* hs = cs + CH * LDN;         // [N][P], the carried state
  float* dts = hs + N * P;           // [CH]
  float* cum = dts + CH;             // [CH], inclusive cumsum of dt*A
  float* ecum = cum + CH;            // [CH], exp(cum)
  float* w = ecum + CH;              // [CH], dt exp(total - cum)
  float* sc = w + CH;                // [RT][LDS]
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const float a = A[h];
  x += b * x_sb + h * x_sh;
  dt += b * dt_sb + h * dt_sh;
  Bm += b * b_sb;
  Cm += b * c_sb;
  y += b * y_sb + h * y_sh;
  const int np4 = P / 4;

  for (int e = tid; e < N * P; e += NT) hs[e] = 0.f;

  for (int c0 = 0; c0 < S; c0 += CH) {
    const int len = min(CH, S - c0);
    // stage the chunk in f32, zero past S
    for (int e = tid; e < CH * P; e += NT) {
      const int s = e / P, p = e % P;
      xs[e] = s < len ? widen(x[(int64_t)(c0 + s) * x_ss + (int64_t)p * x_sp])
                      : 0.f;
    }
    for (int e = tid; e < CH * N; e += NT) {
      const int s = e / N, n = e % N;
      const int64_t t = c0 + s;
      bs[s * LDN + n] = s < len ? widen(Bm[t * b_ss + (int64_t)n * b_sn]) : 0.f;
      cs[s * LDN + n] = s < len ? widen(Cm[t * c_ss + (int64_t)n * c_sn]) : 0.f;
    }
    for (int s = tid; s < CH; s += NT)
      dts[s] = s < len ? dt[(int64_t)(c0 + s) * dt_ss] : 0.f;
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int s = 0; s < CH; ++s) {
        run += __fmul_rn(dts[s], a);   // dA = dt * A rounded, then summed
        cum[s] = run;
      }
    }
    __syncthreads();
    const float total = cum[CH - 1];
    // read after the first __syncthreads of the row-tile loop below
    for (int s = tid; s < CH; s += NT) {
      ecum[s] = expf(cum[s]);
      w[s] = dts[s] * expf(total - cum[s]);
    }

    for (int t0 = 0; t0 < len; t0 += RT) {
      const int rows = min(RT, len - t0), ncols = t0 + rows;
      // scores[r][s] = (C_t . B_s) exp(cum_t - cum_s) dt_s for s <= t,
      // 0 above the diagonal; four rows a thread share one B row
      const int nrq = (rows + 3) / 4;
      for (int e = tid; e < nrq * ncols; e += NT) {
        const int r0 = (e / ncols) * 4, s = e % ncols;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        if (s <= t0 + r0 + 3) {
          for (int n = 0; n < N; n += 4) {
            const float4 bv = ld4(bs + s * LDN + n);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float4 cv = ld4(cs + min(t0 + r0 + i, CH - 1) * LDN + n);
              acc[i] = fmaf(cv.x, bv.x, acc[i]);
              acc[i] = fmaf(cv.y, bv.y, acc[i]);
              acc[i] = fmaf(cv.z, bv.z, acc[i]);
              acc[i] = fmaf(cv.w, bv.w, acc[i]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = r0 + i, t = t0 + r;
          if (r < rows)
            sc[r * LDS + s] =
                s <= t ? acc[i] * expf(cum[t] - cum[s]) * dts[s] : 0.f;
        }
      }
      __syncthreads();
      // y[t] = scores[t] @ x + exp(cum_t) (C_t @ h): two rows x four
      // columns a thread
      const int nrp = (rows + 1) / 2;
      for (int e = tid; e < nrp * np4; e += NT) {
        const int r0 = (e / np4) * 2, p = (e % np4) * 4;
        const int t = t0 + r0;
        const bool two = r0 + 1 < rows;
        float4 y0 = make_float4(0.f, 0.f, 0.f, 0.f), y1 = y0;
        const int smax = min(ncols, t + 2);
        for (int s = 0; s < smax; ++s) {
          const float4 xv = ld4(xs + s * P + p);
          fma4(y0, sc[r0 * LDS + s], xv);
          fma4(y1, two ? sc[(r0 + 1) * LDS + s] : 0.f, xv);
        }
        float4 g0 = make_float4(0.f, 0.f, 0.f, 0.f), g1 = g0;
        const int t1 = two ? t + 1 : t;
        for (int n = 0; n < N; ++n) {
          const float4 hv = ld4(hs + n * P + p);
          fma4(g0, cs[t * LDN + n], hv);
          fma4(g1, cs[t1 * LDN + n], hv);
        }
        fma4(y0, ecum[t], g0);
        T* yr = y + (int64_t)(c0 + t) * y_ss + (int64_t)p * y_sp;
        yr[0] = narrow<T>(y0.x);
        yr[y_sp] = narrow<T>(y0.y);
        yr[2 * y_sp] = narrow<T>(y0.z);
        yr[3 * y_sp] = narrow<T>(y0.w);
        if (two) {
          fma4(y1, ecum[t1], g1);
          yr += y_ss;
          yr[0] = narrow<T>(y1.x);
          yr[y_sp] = narrow<T>(y1.y);
          yr[2 * y_sp] = narrow<T>(y1.z);
          yr[3 * y_sp] = narrow<T>(y1.w);
        }
      }
      __syncthreads();
    }

    // B <- w B in place (the TPU kernel's w), then h <- exp(total) h + wᵀ x:
    // two state rows x four columns a thread
    for (int e = tid; e < CH * N; e += NT) {
      const int s = e / N, n = e % N;
      bs[s * LDN + n] *= w[s];
    }
    __syncthreads();
    const float et = expf(total);
    for (int e = tid; e < (N / 2) * np4; e += NT) {
      const int n0 = (e / np4) * 2, p = (e % np4) * 4;
      float4 a0 = make_float4(0.f, 0.f, 0.f, 0.f), a1 = a0;
      for (int s = 0; s < len; ++s) {
        const float4 xv = ld4(xs + s * P + p);
        fma4(a0, bs[s * LDN + n0], xv);
        fma4(a1, bs[s * LDN + n0 + 1], xv);
      }
      float4* h0 = reinterpret_cast<float4*>(hs + n0 * P + p);
      float4* h1 = reinterpret_cast<float4*>(hs + (n0 + 1) * P + p);
      float4 v0 = *h0, v1 = *h1;
      *h0 = make_float4(fmaf(et, v0.x, a0.x), fmaf(et, v0.y, a0.y),
                        fmaf(et, v0.z, a0.z), fmaf(et, v0.w, a0.w));
      *h1 = make_float4(fmaf(et, v1.x, a1.x), fmaf(et, v1.y, a1.y),
                        fmaf(et, v1.z, a1.z), fmaf(et, v1.w, a1.w));
    }
    __syncthreads();
  }
}

template <typename T, int CH>
cudaError_t launch(const void* x, const long long* xs, const void* dt,
                   const long long* dts, const void* A, const void* B,
                   const long long* bs, const void* C, const long long* cs,
                   void* y, const long long* ys, int Bt, int S, int H, int N,
                   int P, cudaStream_t stream) {
  void (*kern)(const T*, int64_t, int64_t, int64_t, int64_t, const float*,
               int64_t, int64_t, int64_t, const float*, const T*, int64_t,
               int64_t, int64_t, const T*, int64_t, int64_t, int64_t, T*,
               int64_t, int64_t, int64_t, int64_t, int, int, int) =
      ssd_scan_kernel<T, CH>;
  // opt in to the most dynamic shared memory any (N, P) of this instance
  // takes, once per instance
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(smem_floats(CH, NMAX, PMAX) * sizeof(float)));
  if (attr != cudaSuccess) return attr;
  const size_t smem = smem_floats(CH, N, P) * sizeof(float);
  dim3 grid(H, Bt);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), xs[0], xs[1], xs[2], xs[3],
      static_cast<const float*>(dt), dts[0], dts[1], dts[2],
      static_cast<const float*>(A), static_cast<const T*>(B), bs[0], bs[1],
      bs[2], static_cast<const T*>(C), cs[0], cs[1], cs[2],
      static_cast<T*>(y), ys[0], ys[1], ys[2], ys[3], S, N, P);
  return cudaGetLastError();
}

}  // namespace

// dtype 0 = f32, 1 = bf16 (of x, B, C and y; dt and A are f32).  Strides:
// x and y four, (Bt, S, H, P); dt three, (Bt, S, H); B and C three,
// (Bt, S, N) (their head axis has extent 1); A is contiguous.  Returns 0
// on success, a cudaError_t code if the launch failed, and -1 when
// (dtype, chunk, N, P) is not an instance.
extern "C" int ssd_scan(int dtype, int chunk, const void* x,
                        const long long* x_strides, const void* dt,
                        const long long* dt_strides, const void* A,
                        const void* B, const long long* b_strides,
                        const void* C, const long long* c_strides, void* y,
                        const long long* y_strides, int Bt, int S, int H,
                        int N, int P, void* stream) {
  if (N < 4 || N > NMAX || N % 4 || P < 4 || P > PMAX || P % 4) return -1;
#define SSD_INSTANCE(CODE, T, CH)                                            \
  if (dtype == CODE && chunk == CH)                                          \
    return (int)launch<T, CH>(x, x_strides, dt, dt_strides, A, B, b_strides, \
                              C, c_strides, y, y_strides, Bt, S, H, N, P,    \
                              static_cast<cudaStream_t>(stream));
#define SSD_CHUNKS(CODE, T)                                                  \
  SSD_INSTANCE(CODE, T, 16)                                                  \
  SSD_INSTANCE(CODE, T, 32)                                                  \
  SSD_INSTANCE(CODE, T, 64)                                                  \
  SSD_INSTANCE(CODE, T, 128)
  SSD_CHUNKS(0, float)
  SSD_CHUNKS(1, __nv_bfloat16)
#undef SSD_CHUNKS
#undef SSD_INSTANCE
  return -1;
}
