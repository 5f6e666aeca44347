// Mamba-2 SSD (state-space duality) chunked scan for Hopper (sm_90a),
// plain C interface: the chunks in parallel, in three launches.
//
// Replaces the TPU kernel repro/kernels/ssd.py::_body (called through
// ssd_scan): y = SSD(x, dt, A, B, C) over chunks of CH tokens, the D skip
// left to the caller.  x (Bt, S, H, P) and y in f32 or bf16; dt (Bt, S, H)
// and A (H,) in f32; B and C (Bt, S, 1, N), shared by every head.  Each is
// read or written through its strides, so the views the model cuts from
// its conv output (x, B and C side by side in one row) need no copy.
//
// What bounds it on an H100: per (batch, chunk) of c tokens the lower
// triangle of C Bᵀ (c(c+1)/2 dots of length N, shared by every head), and
// per head the triangle of the scores times x (c(c+1)/2 x P), C @ h and
// the chunk's state (2 x c N P multiply-adds each).  At mamba2-780m's
// chunk 128, N 128, P 64, 48 heads that is some 100 flops a byte of x, y,
// B and C, past the f32 ridge of 67 / 3.35 = 20: the card's bound is its
// f32 operations (67 TFLOP/s on the CUDA cores; the TPU kernel's dots are
// f32 too, and no TF32 is used here).
//
// Design: the chunk-parallel SSD decomposition of the Mamba-2 paper
// (arXiv:2405.21060, §6).  The TPU kernel walked the chunks of a head in
// order, carrying the (N, P) state in VMEM scratch; here the chunks run in
// parallel and only an elementwise pass is sequential:
//   1. ssd_state_kernel, grid (chunks - 1, H / HG1, Bt): per (batch,
//      chunk, group of HG1 heads) B is staged once; per head the chunk's
//      cumsum of dt*A, w = dt exp(total - cum), and the chunk's own state
//      s_c = Σ_s B_s ⊗ (w_s x_s) (N x P, f32) into a scratch of
//      Bt x chunks x H x N x P floats, with exp(total) beside it (the last
//      chunk's state feeds nothing, so it is not formed);
//   2. ssd_pass_kernel, grid (N P / 4 / 256, H, Bt): per state element the
//      16-step scan h_c = exp(total_{c-1}) h_{c-1} + s_{c-1}, h_0 = 0,
//      written in place, so slot c then holds the state entering chunk c
//      (eight chunks' loads in flight at a time);
//   3. ssd_out_kernel, grid (chunks, H / HG3, Bt): per (batch, chunk,
//      group of HG3 heads) C and B are staged and the lower triangle of
//      C Bᵀ is formed once, in registers (4 x 4 tiles a thread); per head
//      the scores C Bᵀ ⊙ L ⊙ dt are written to shared memory from those
//      registers, and y = exp(cum) (C @ h_c) + scores @ x is stored in x's
//      dtype, only for rows before S.
// A scan of one chunk (S <= CH) is kernel 3 alone, with no state.  The
// wrapper (kernels/ssd.py::launch_plan) picks HG1 and HG3: the divisor of
// H whose grid, in waves of the blocks the card holds at once, takes the
// least time, the larger group on a tie (fewer stagings of B, fewer C Bᵀ).
//
// Per chunk the cumsum of dt*A (dA rounded once, __fmul_rn) is one warp's
// inclusive scan: each lane sums its run of CH/32 in order, then the lane
// totals are scanned by shuffles.  dt is staged zero past S, so dt and
// dt*A are 0 there and the state does not move; x, B and C are zero past
// S too.  L = exp(cum_t - cum_s) overflows to inf above the diagonal,
// where the TPU kernel computed it and selected it away: here it is never
// formed (a score is written only for s <= t, and the y loops stop at t).
// Inner loops read shared memory as 16-byte loads into register tiles of
// 4 rows x 8 columns a thread (two 4-column halves PP/2 apart, PP = P
// rounded up to 8), so a multiply-add costs well under one load.  x, h and
// the chunk states are held PP wide, the columns past P zero; y is stored
// for the columns before P only.
//
// Shared memory, in floats.  Kernel 1: B CH (N + 4), x CH PP, three
// CH-vectors: 101,888 B at CH 128, N 128, P 64 (two blocks an SM).
// Kernel 3: C CH (N + 4); one region that holds B while C Bᵀ is formed,
// then x CH PP and h N PP; the scores CH (CH + 4); three CH-vectors:
// 204,288 B (one block an SM).  Rows are padded by 4 floats so 16-byte
// loads down a column of rows spread over the banks.  Instances: CH in
// {16, 32, 64, 128} x {f32, bf16}; N and P are run-time values, each a
// multiple of 4, N up to 128 and P up to 64.
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
constexpr int PAD = 4;        // floats of padding on a B, C or score row

// the width x, h and the chunk states are held at: P rounded up to 8
__host__ __device__ constexpr int padded(int P) { return (P + 7) & ~7; }

// floats of dynamic shared memory of one block of kernel 1 and kernel 3
__host__ __device__ constexpr size_t state_floats(int CH, int N, int P) {
  return (size_t)CH * (N + PAD) + (size_t)CH * padded(P) + 3 * (size_t)CH;
}
__host__ __device__ constexpr size_t region_floats(int CH, int N, int P) {
  return (size_t)CH * (N + PAD) > (size_t)(CH + N) * padded(P)
             ? (size_t)CH * (N + PAD) : (size_t)(CH + N) * padded(P);
}
__host__ __device__ constexpr size_t out_floats(int CH, int N, int P) {
  return (size_t)CH * (N + PAD) + region_floats(CH, N, P) +
         (size_t)CH * (CH + PAD) + 3 * (size_t)CH;
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

__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Strides of one operand (elements).
struct Str4 {
  int64_t b, s, h, p;
};

// rows[s][j] = widen(x[t0 + s, j * sj]) for s < len and j < W, 0 for
// len <= s < CH or W <= j < WP (W and WP multiples of 4); row stride LD
// floats.  Rows of unit stride whose every 4-element run starts
// 4-element-aligned (the model's views) are read 4 elements a load (16
// bytes in f32, 8 in bf16), else element by element.
template <typename T>
__device__ __forceinline__ void stage_rows(float* rows, int LD, int CH, int W,
                                           int WP, const T* __restrict__ x,
                                           int64_t ss, int64_t sj, int len) {
  constexpr int VB = 4 * (int)sizeof(T);   // bytes of 4 elements
  if (sj == 1 && ss % 4 == 0 &&
      reinterpret_cast<uintptr_t>(x) % VB == 0) {
    const int w4 = WP / 4;
    for (int e = threadIdx.x; e < CH * w4; e += NT) {
      const int s = e / w4, j = (e % w4) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (s < len && j < W) {
        const T* p = x + (int64_t)s * ss + j;
        if constexpr (sizeof(T) == 4) {
          v = *reinterpret_cast<const float4*>(p);
        } else {
          const uint2 u = *reinterpret_cast<const uint2*>(p);
          const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
          const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
          v = make_float4(__low2float(lo), __high2float(lo), __low2float(hi),
                          __high2float(hi));
        }
      }
      *reinterpret_cast<float4*>(rows + s * LD + j) = v;
    }
    return;
  }
  for (int e = threadIdx.x; e < CH * WP; e += NT) {
    const int s = e / WP, j = e % WP;
    rows[s * LD + j] = s < len && j < W
                           ? widen(x[(int64_t)s * ss + (int64_t)j * sj])
                           : 0.f;
  }
}

// cum[s] = Σ_{u <= s} dt[u] * a over the chunk (dA rounded once), by
// warp 0: each lane sums its run of CH / 32 in order, then the runs'
// totals are scanned across the lanes.  The caller synchronises after.
template <int CH>
__device__ __forceinline__ void chunk_cumsum(const float* dts, float a,
                                             float* cum) {
  constexpr int E = CH < 32 ? 1 : CH / 32;   // elements a lane
  const int lane = threadIdx.x % 32;
  if (threadIdx.x >= 32) return;
  float v[E];
  float run = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int s = lane * E + e;
    run += s < CH ? __fmul_rn(dts[s], a) : 0.f;
    v[e] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const float up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  float before = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) before = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int s = lane * E + e;
    if (s < CH) cum[s] = before + v[e];
  }
}

// ---------------------------------------------------------------------------
// Kernel 1: each chunk's own state, s_c = Σ_s B_s ⊗ (w_s x_s).
// ---------------------------------------------------------------------------

template <typename T, int CH>
__global__ void __launch_bounds__(NT, 2)
ssd_state_kernel(const T* __restrict__ x, Str4 xs_, const float* __restrict__ dt,
                 Str4 ds_, const float* __restrict__ A,
                 const T* __restrict__ Bm, Str4 bs_, float* __restrict__ st,
                 float* __restrict__ et, int S, int H, int N, int P, int nc,
                 int hg) {
  extern __shared__ __align__(16) float sm[];
  const int LDN = N + PAD, PP = padded(P);
  float* bs = sm;                    // [CH][LDN]
  float* xs = bs + CH * LDN;         // [CH][PP], then w_s x_s
  float* dts = xs + CH * PP;         // [CH]
  float* cum = dts + CH;             // [CH]
  float* w = cum + CH;               // [CH]
  const int c = blockIdx.x, b = blockIdx.z, tid = threadIdx.x;
  const int c0 = c * CH, len = min(CH, S - c0);
  const int hp = PP / 2, npg = PP / 8;
  stage_rows(bs, LDN, CH, N, N, Bm + b * bs_.b + (int64_t)c0 * bs_.s, bs_.s,
             bs_.p, len);
  for (int hd = 0; hd < hg; ++hd) {
    const int h = blockIdx.y * hg + hd;
    stage_rows(xs, PP, CH, P, PP,
               x + b * xs_.b + (int64_t)c0 * xs_.s + h * xs_.h, xs_.s, xs_.p,
               len);
    for (int s = tid; s < CH; s += NT)
      dts[s] = s < len ? dt[b * ds_.b + (int64_t)(c0 + s) * ds_.s + h * ds_.h]
                       : 0.f;
    __syncthreads();
    chunk_cumsum<CH>(dts, A[h], cum);
    __syncthreads();
    const float total = cum[CH - 1];
    for (int s = tid; s < CH; s += NT) w[s] = dts[s] * expf(total - cum[s]);
    __syncthreads();
    for (int e = tid; e < CH * PP; e += NT) xs[e] *= w[e / PP];
    __syncthreads();
    // 4 state rows (n) x 8 columns (p) a thread
    float* out = st + ((int64_t)(b * nc + c) * H + h) * N * PP;
    for (int u = tid; u < (N / 4) * npg; u += NT) {
      const int n0 = (u / npg) * 4, p0 = (u % npg) * 4;
      float4 a0[4], a1[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a0[i] = a1[i] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int s = 0; s < len; ++s) {
        const float4 bv = ld4(bs + s * LDN + n0);
        const float4 x0 = ld4(xs + s * PP + p0),
                     x1 = ld4(xs + s * PP + hp + p0);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          fma4(a0[i], at(bv, i), x0);
          fma4(a1[i], at(bv, i), x1);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        *reinterpret_cast<float4*>(out + (n0 + i) * PP + p0) = a0[i];
        *reinterpret_cast<float4*>(out + (n0 + i) * PP + hp + p0) = a1[i];
      }
    }
    if (tid == 0) et[(int64_t)(b * nc + c) * H + h] = expf(total);
    __syncthreads();   // xs and the vectors are restaged for the next head
  }
}

// ---------------------------------------------------------------------------
// Kernel 2: the state entering each chunk, in place.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NT)
ssd_pass_kernel(float* __restrict__ st, const float* __restrict__ et, int H,
                int NP, int nc) {
  const int q = blockIdx.x * NT + threadIdx.x, h = blockIdx.y,
            b = blockIdx.z;
  if (q * 4 >= NP) return;
  // eight chunks' loads in flight at a time, then their scan in order;
  // the last chunk's own state feeds nothing and is never read
  constexpr int BATCH = 8;
  float4 run = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += BATCH) {
    float4 s[BATCH];
    float e[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int c = c0 + j;
      if (c + 1 < nc) {
        const int64_t i = (int64_t)(b * nc + c) * H + h;
        s[j] = __ldcg(reinterpret_cast<const float4*>(st + i * NP) + q);
        e[j] = et[i];
      }
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int c = c0 + j;
      if (c >= nc) break;
      const int64_t i = (int64_t)(b * nc + c) * H + h;
      __stcg(reinterpret_cast<float4*>(st + i * NP) + q, run);
      if (c + 1 < nc)
        run = make_float4(fmaf(e[j], run.x, s[j].x), fmaf(e[j], run.y, s[j].y),
                          fmaf(e[j], run.z, s[j].z), fmaf(e[j], run.w, s[j].w));
    }
  }
}

// ---------------------------------------------------------------------------
// Kernel 3: y = exp(cum) (C @ h_c) + (C Bᵀ ⊙ L ⊙ dt) @ x, C Bᵀ once a group.
// ---------------------------------------------------------------------------

// The 4 x 4 tiles of the lower triangle of a (CH x CH) matrix, diagonal
// tiles included: tile q holds rows 4 ti.., columns 4 si.., si <= ti,
// q = ti (ti + 1) / 2 + si.
template <int CH>
struct Tri {
  static constexpr int TILES = (CH / 4) * (CH / 4 + 1) / 2;
  static constexpr int PER = (TILES + NT - 1) / NT;   // tiles a thread
};

__device__ __forceinline__ void tri_tile(int q, int& ti, int& si) {
  int t = (int)((sqrtf(8.f * q + 1.f) - 1.f) * 0.5f);
  while (t * (t + 1) / 2 > q) --t;
  while ((t + 1) * (t + 2) / 2 <= q) ++t;
  ti = t;
  si = q - t * (t + 1) / 2;
}

// One block an SM (its shared memory) is stated to ptxas: without it the
// chunk-128 instances were held to 128 registers and spilled.
template <typename T, int CH>
__global__ void __launch_bounds__(NT, 1)
ssd_out_kernel(const T* __restrict__ x, Str4 xs_, const float* __restrict__ dt,
               Str4 ds_, const float* __restrict__ A, const T* __restrict__ Bm,
               Str4 bs_, const T* __restrict__ Cm, Str4 cs_, T* __restrict__ y,
               Str4 ys_, const float* __restrict__ st, int S, int H, int N,
               int P, int nc, int hg) {
  typedef Tri<CH> TR;
  constexpr int RS = CH / 4;         // rows t of a thread are RS apart
  constexpr int LDS = CH + PAD;      // score row stride
  extern __shared__ __align__(16) float sm[];
  const int LDN = N + PAD, PP = padded(P);
  float* cs = sm;                              // [CH][LDN]
  float* reg = cs + CH * LDN;                  // B, then x and h
  float* bs = reg;                             // [CH][LDN]
  float* xs = reg;                             // [CH][PP]
  float* hs = reg + CH * PP;                   // [N][PP]
  float* sc = reg + region_floats(CH, N, P);   // [CH][LDS]
  float* dts = sc + CH * LDS;                  // [CH]
  float* cum = dts + CH;                       // [CH]
  float* ecum = cum + CH;                      // [CH]
  const int c = blockIdx.x, b = blockIdx.z, tid = threadIdx.x;
  const int c0 = c * CH, len = min(CH, S - c0);
  const bool has_state = st != nullptr && c > 0;
  const int hp = PP / 2, npg = PP / 8;

  stage_rows(cs, LDN, CH, N, N, Cm + b * cs_.b + (int64_t)c0 * cs_.s, cs_.s,
             cs_.p, len);
  stage_rows(bs, LDN, CH, N, N, Bm + b * bs_.b + (int64_t)c0 * bs_.s, bs_.s,
             bs_.p, len);
  __syncthreads();
  // the lower triangle of C Bᵀ, once for the group: 4 x 4 tiles a thread
  float cb[TR::PER][4][4];
#pragma unroll
  for (int k = 0; k < TR::PER; ++k) {
    const int q = tid + k * NT;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) cb[k][r][j] = 0.f;
    if (q >= TR::TILES) continue;
    int ti, si;
    tri_tile(q, ti, si);
    for (int n = 0; n < N; n += 4) {
      float4 cv[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        cv[r] = ld4(cs + (4 * ti + r) * LDN + n);
        bv[r] = ld4(bs + (4 * si + r) * LDN + n);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          cb[k][r][j] = fmaf(cv[r].x, bv[j].x, cb[k][r][j]);
          cb[k][r][j] = fmaf(cv[r].y, bv[j].y, cb[k][r][j]);
          cb[k][r][j] = fmaf(cv[r].z, bv[j].z, cb[k][r][j]);
          cb[k][r][j] = fmaf(cv[r].w, bv[j].w, cb[k][r][j]);
        }
    }
  }
  __syncthreads();   // B's region is free for x and h

  for (int hd = 0; hd < hg; ++hd) {
    const int h = blockIdx.y * hg + hd;
    stage_rows(xs, PP, CH, P, PP,
               x + b * xs_.b + (int64_t)c0 * xs_.s + h * xs_.h, xs_.s, xs_.p,
               len);
    if (has_state) {
      const float4* src = reinterpret_cast<const float4*>(
          st + ((int64_t)(b * nc + c) * H + h) * N * PP);
      for (int e = tid; e < N * PP / 4; e += NT)
        reinterpret_cast<float4*>(hs)[e] = src[e];
    }
    for (int s = tid; s < CH; s += NT)
      dts[s] = s < len ? dt[b * ds_.b + (int64_t)(c0 + s) * ds_.s + h * ds_.h]
                       : 0.f;
    __syncthreads();
    chunk_cumsum<CH>(dts, A[h], cum);
    __syncthreads();
    for (int s = tid; s < CH; s += NT) ecum[s] = expf(cum[s]);
    // scores[t][s] = (C_t . B_s) exp(cum_t - cum_s) dt_s for s <= t
#pragma unroll
    for (int k = 0; k < TR::PER; ++k) {
      const int q = tid + k * NT;
      if (q >= TR::TILES) continue;
      int ti, si;
      tri_tile(q, ti, si);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = 4 * ti + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = 4 * si + j;
          sc[t * LDS + s] =
              s <= t ? cb[k][r][j] * expf(cum[t] - cum[s]) * dts[s] : 0.f;
        }
      }
    }
    __syncthreads();
    // rows rg + RS i (i < 4) x columns p0.. and hp + p0.. a thread
    for (int u = tid; u < RS * npg; u += NT) {
      const int rg = u / npg, p0 = (u % npg) * 4;
      float4 a0[4], a1[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a0[i] = a1[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (has_state) {
#pragma unroll 2
        for (int n = 0; n < N; n += 4) {
          float4 cv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = ld4(cs + (rg + RS * i) * LDN + n);
#pragma unroll
          for (int nn = 0; nn < 4; ++nn) {
            const float4 h0 = ld4(hs + (n + nn) * PP + p0);
            const float4 h1 = ld4(hs + (n + nn) * PP + hp + p0);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              fma4(a0[i], at(cv[i], nn), h0);
              fma4(a1[i], at(cv[i], nn), h1);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float e = ecum[rg + RS * i];
          a0[i] = make_float4(e * a0[i].x, e * a0[i].y, e * a0[i].z,
                              e * a0[i].w);
          a1[i] = make_float4(e * a1[i].x, e * a1[i].y, e * a1[i].z,
                              e * a1[i].w);
        }
      }
      // the triangle in four segments: s in (t_{g-1}, t_g] feeds rows g..3
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int lo = g == 0 ? 0 : rg + RS * (g - 1) + 1;
        const int hi = min(rg + RS * g + 1, len);
#pragma unroll 4
        for (int s = lo; s < hi; ++s) {
          const float4 x0 = ld4(xs + s * PP + p0),
                     x1 = ld4(xs + s * PP + hp + p0);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (i >= g) {
              const float v = sc[(rg + RS * i) * LDS + s];
              fma4(a0[i], v, x0);
              fma4(a1[i], v, x1);
            }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = rg + RS * i;
        if (t >= len) continue;
        T* yr = y + b * ys_.b + (int64_t)(c0 + t) * ys_.s + h * ys_.h;
        const float v[8] = {a0[i].x, a0[i].y, a0[i].z, a0[i].w,
                            a1[i].x, a1[i].y, a1[i].z, a1[i].w};
        // the first half's columns are all before P (p0 < PP / 2 <= P); the
        // second half's all before P or all past it (P a multiple of 4)
        const bool second = hp + p0 < P;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (j < 4 || second)
            yr[(int64_t)((j < 4 ? 0 : hp) + p0 + (j & 3)) * ys_.p] =
                narrow<T>(v[j]);
      }
    }
    __syncthreads();   // x, h, the scores and the vectors are restaged
  }
}

Str4 str(const long long* s, int n) {
  Str4 r{s[0], s[1], n > 3 ? s[2] : 0, n > 3 ? s[3] : s[2]};
  return r;
}

template <typename T, int CH>
cudaError_t launch(const void* x, const long long* xs, const void* dt,
                   const long long* dts, const void* A, const void* B,
                   const long long* bs, const void* C, const long long* cs,
                   void* y, const long long* ys, int Bt, int S, int H, int N,
                   int P, int hg1, int hg3, float* scratch,
                   cudaStream_t stream, int* launched) {
  const int nc = (S + CH - 1) / CH, NP = N * padded(P);
  const Str4 X = str(xs, 4), Y = str(ys, 4), Bs = str(bs, 3), Cs = str(cs, 3);
  // dt is (Bt, S, H): its strides as (b, s, h)
  const Str4 D{dts[0], dts[1], dts[2], 0};
  float* st = nullptr;
  if (nc > 1) {
    void (*k1)(const T*, Str4, const float*, Str4, const float*, const T*,
               Str4, float*, float*, int, int, int, int, int, int) =
        ssd_state_kernel<T, CH>;
    static const cudaError_t a1 = cudaFuncSetAttribute(
        k1, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(state_floats(CH, NMAX, PMAX) * sizeof(float)));
    if (a1 != cudaSuccess) return a1;
    st = scratch;
    float* et = scratch + (size_t)Bt * nc * H * NP;
    k1<<<dim3(nc - 1, H / hg1, Bt), NT,
         state_floats(CH, N, P) * sizeof(float), stream>>>(
        static_cast<const T*>(x), X, static_cast<const float*>(dt), D,
        static_cast<const float*>(A), static_cast<const T*>(B), Bs, st, et,
        S, H, N, P, nc, hg1);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    ++*launched;
    ssd_pass_kernel<<<dim3((NP / 4 + NT - 1) / NT, H, Bt), NT, 0,
                      stream>>>(st, et, H, NP, nc);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    ++*launched;
  }
  void (*k3)(const T*, Str4, const float*, Str4, const float*, const T*,
             Str4, const T*, Str4, T*, Str4, const float*, int, int, int,
             int, int, int) = ssd_out_kernel<T, CH>;
  static const cudaError_t a3 = cudaFuncSetAttribute(
      k3, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(out_floats(CH, NMAX, PMAX) * sizeof(float)));
  if (a3 != cudaSuccess) return a3;
  k3<<<dim3(nc, H / hg3, Bt), NT, out_floats(CH, N, P) * sizeof(float),
       stream>>>(static_cast<const T*>(x), X, static_cast<const float*>(dt),
                 D, static_cast<const float*>(A), static_cast<const T*>(B),
                 Bs, static_cast<const T*>(C), Cs, static_cast<T*>(y), Y, st,
                 S, H, N, P, nc, hg3);
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) ++*launched;
  return e;
}

}  // namespace

// dtype 0 = f32, 1 = bf16 (of x, B, C and y; dt and A are f32).  Strides:
// x and y four, (Bt, S, H, P); dt three, (Bt, S, H); B and C three,
// (Bt, S, N) (their head axis has extent 1); A is contiguous.  hg3 and,
// when S > chunk, hg1 divide H (heads a block of kernel 3 and kernel 1);
// scratch then holds Bt x chunks x H x (N PP + 1) floats (PP = P rounded
// up to 8), else may be null.  *launched is set to the kernels queued.
// Returns 0 on success, a cudaError_t code if a launch failed, and -1
// when (dtype, chunk, N, P, hg1, hg3) is not an instance.
extern "C" int ssd_scan(int dtype, int chunk, const void* x,
                        const long long* x_strides, const void* dt,
                        const long long* dt_strides, const void* A,
                        const void* B, const long long* b_strides,
                        const void* C, const long long* c_strides, void* y,
                        const long long* y_strides, int Bt, int S, int H,
                        int N, int P, int hg1, int hg3, void* scratch,
                        void* stream, int* launched) {
  *launched = 0;
  if (N < 4 || N > NMAX || N % 4 || P < 4 || P > PMAX || P % 4 ||
      hg3 < 1 || H % hg3 ||
      (S > chunk && (scratch == nullptr || hg1 < 1 || H % hg1)))
    return -1;
#define SSD_INSTANCE(CODE, T, CH)                                            \
  if (dtype == CODE && chunk == CH)                                          \
    return (int)launch<T, CH>(x, x_strides, dt, dt_strides, A, B, b_strides, \
                              C, c_strides, y, y_strides, Bt, S, H, N, P,    \
                              hg1, hg3, static_cast<float*>(scratch),        \
                              static_cast<cudaStream_t>(stream), launched);
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
