// Flash attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_body (called
// through flash_attention): online-softmax GQA attention, causal with a
// query offset, an optional sliding window, f32 running max, sum and
// accumulator, output in q's dtype.  q (B, Hq, Sq, D); k, v (B, Hkv, Sk, D);
// o (B, Hq, Sq, D); each read or written through its four strides, so the
// transposed head views of models/layers.py::_split_heads need no copy.
//
// What bounds it on an H100: causal attention over S keys does
// 4 * D * S(S+1)/2 flops a head against 4 * S * D elements of I/O; at a
// real prefill (olmo-1b, D = 128, S = 2048) that is ~512 flops per byte of
// bf16, past the bf16 ridge of ~295, so the card's bound is its operations
// (989 TFLOP/s bf16 on the tensor cores).  This first kernel does its
// products as f32 FMAs on the CUDA cores (67 TFLOP/s peak, less here
// because its inner loops feed from shared memory), so it runs far above
// that bound; moving the two products onto wgmma is later work.  What the
// design does about the bytes: each K/V element is read from HBM once per
// block of BQ query rows (the q tile stays in shared memory for the whole
// KV loop), and the KV tiles that the causal or the window mask rules out
// are never loaded.
//
// Design (per CUDA block, NT = 128 threads; grid (ceil(Sq/BQ), Hq, B)):
//   * the block owns BQ = 32 query rows of one (batch, head); its kv head
//     is head / (Hq / Hkv), so GQA never repeats K or V in memory;
//   * a loop over KV tiles of BKV = 32 keys, in order, replaces the TPU's
//     sequential KV grid axis; the causal loop ends after the block's last
//     query, the window loop starts at the first tile the block's first
//     query can see (the TPU kernel's block-skip predicates);
//   * the q, k and v tiles are widened to f32 in shared memory and
//     zero-filled past Sq and Sk (the TPU kernel read padding and zeroed
//     v with a where); nothing past Sq or Sk is read or written;
//   * four threads per query row: each computes 8 of the tile's 32 scores;
//     the row's max and sum go through two warp shuffles, its
//     probabilities through shared memory into the P @ V product, where
//     each thread owns D/4 columns of the row's f32 accumulator;
//   * masks per element as the TPU kernel's: ki < Sk, causal ki <= qi,
//     window ki > qi - window (qi offset by q_offset).  Masked scores take
//     the finite NEG_INF = -1e30 and their probabilities are zeroed, so a
//     row with no valid key ends with l = 0 and writes 0, never NaN;
//   * the output is acc / max(l, 1e-37), cast once to q's dtype.
// f32 and bf16, head dims 16, 32, 64, 128 and 256 (template instances).
// Shared memory is (BQ + 2 BKV)(D + 1) + BQ (BKV + 1) floats, rows padded
// by one float against bank conflicts: 53,760 bytes at D = 128 and 102,912
// at D = 256, so those launches opt in to dynamic shared memory above
// 48 KB.
//
// Built by repro_torch/kernels/build.py as one nvcc job into the same
// library as the GEMM kernels.

#include "tile.cuh"

namespace {

using iaat::narrow;
using iaat::widen;

constexpr int NT = 128;            // threads per block
constexpr int BQ = 32;             // query rows per block
constexpr int BKV = 32;            // keys per KV tile
constexpr int TPR = NT / BQ;       // threads per query row
constexpr int SPT = BKV / TPR;     // scores per thread and tile
constexpr float NEG_INF = -1e30f;  // flash_attention.py's finite -inf

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((size_t)(BQ + 2 * BKV) * (D + 1) + (size_t)BQ * (BKV + 1));
}

// tile[r][d] = x[(r0 + r) * s_r + d * s_d] widened to f32, 0 where
// r0 + r >= R; consecutive threads walk d, the unit-stride dim.
template <typename T, int ROWS, int D>
__device__ __forceinline__ void load_rows(float* __restrict__ tile,
                                          const T* __restrict__ x,
                                          int64_t s_r, int64_t s_d, int r0,
                                          int R) {
  for (int e = threadIdx.x; e < ROWS * D; e += NT) {
    const int r = e / D, d = e % D, rg = r0 + r;
    tile[r * (D + 1) + d] =
        rg < R ? widen(x[(int64_t)rg * s_r + (int64_t)d * s_d]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_attention_kernel(const T* __restrict__ Q, int64_t q_sb, int64_t q_sh,
                       int64_t q_ss, int64_t q_sd,
                       const T* __restrict__ K, int64_t k_sb, int64_t k_sh,
                       int64_t k_ss, int64_t k_sd,
                       const T* __restrict__ V, int64_t v_sb, int64_t v_sh,
                       int64_t v_ss, int64_t v_sd,
                       T* __restrict__ O, int64_t o_sb, int64_t o_sh,
                       int64_t o_ss, int64_t o_sd,
                       int rep, int Sq, int Sk, int q_offset, int causal,
                       int window, float scale) {
  constexpr int LD = D + 1, LP = BKV + 1, CPT = D / TPR;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [BQ][LD]
  float* Ks = Qs + BQ * LD;                         // [BKV][LD]
  float* Vs = Ks + BKV * LD;                        // [BKV][LD]
  float* Ps = Vs + BKV * LD;                        // [BQ][LP]

  const int64_t b = blockIdx.z, h = blockIdx.y, hk = h / rep;
  const int q0 = blockIdx.x * BQ;
  const int r = threadIdx.x / TPR, t = threadIdx.x % TPR;
  const T* k = K + b * k_sb + hk * k_sh;
  const T* v = V + b * v_sb + hk * v_sh;
  load_rows<T, BQ, D>(Qs, Q + b * q_sb + h * q_sh, q_ss, q_sd, q0, Sq);

  // absolute position of the block's first query and of this row's
  const int q_start = q0 + q_offset, qi = q_start + r;
  int kv_begin = 0, kv_end = Sk;
  if (causal) kv_end = min(Sk, q_start + BQ);
  if (window > 0) kv_begin = max(0, q_start - window + 1) / BKV * BKV;

  float m = NEG_INF, l = 0.f, acc[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) acc[i] = 0.f;

  for (int k0 = kv_begin; k0 < kv_end; k0 += BKV) {
    __syncthreads();  // the last tile's readers are done
    load_rows<T, BKV, D>(Ks, k, k_ss, k_sd, k0, Sk);
    load_rows<T, BKV, D>(Vs, v, v_ss, v_sd, k0, Sk);
    __syncthreads();

    // this thread's scores: keys k0 + t + j * TPR
    float s[SPT];
#pragma unroll
    for (int j = 0; j < SPT; ++j) s[j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float qv = Qs[r * LD + d];
#pragma unroll
      for (int j = 0; j < SPT; ++j)
        s[j] = fmaf(qv, Ks[(t + j * TPR) * LD + d], s[j]);
    }
    bool ok[SPT];
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const int ki = k0 + t + j * TPR;
      ok[j] = ki < Sk && (!causal || ki <= qi) &&
              (window <= 0 || ki > qi - window);
      s[j] = ok[j] ? s[j] * scale : NEG_INF;
      mx = fmaxf(mx, s[j]);
    }
    // the row's four threads are adjacent lanes of one warp
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const float p = ok[j] ? expf(s[j] - m_new) : 0.f;
      Ps[r * LP + t + j * TPR] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    const float corr = expf(m - m_new);
    l = l * corr + psum;
    m = m_new;
    __syncwarp();  // the row's probabilities, written by its own warp
#pragma unroll
    for (int i = 0; i < CPT; ++i) acc[i] *= corr;
#pragma unroll 4
    for (int c = 0; c < BKV; ++c) {
      const float p = Ps[r * LP + c];
#pragma unroll
      for (int i = 0; i < CPT; ++i)
        acc[i] = fmaf(p, Vs[c * LD + t + i * TPR], acc[i]);
    }
  }

  if (q0 + r < Sq) {
    const float den = fmaxf(l, 1e-37f);
    T* o = O + b * o_sb + h * o_sh + (int64_t)(q0 + r) * o_ss;
#pragma unroll
    for (int i = 0; i < CPT; ++i)
      o[(int64_t)(t + i * TPR) * o_sd] = narrow<T>(acc[i] / den);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const long long* qs, const void* k,
                   const long long* ks, const void* v, const long long* vs,
                   void* o, const long long* os, int B, int Hq, int Hkv,
                   int Sq, int Sk, int q_offset, int causal, int window,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  void (*kern)(const T*, int64_t, int64_t, int64_t, int64_t, const T*,
               int64_t, int64_t, int64_t, int64_t, const T*, int64_t,
               int64_t, int64_t, int64_t, T*, int64_t, int64_t, int64_t,
               int64_t, int, int, int, int, int, int, float) =
      flash_attention_kernel<T, D>;
  if (smem > 48 * 1024) {
    // opt in to dynamic shared memory above 48 KB, once per instance
    static const cudaError_t attr = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return attr;
  }
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), qs[0], qs[1], qs[2], qs[3],
      static_cast<const T*>(k), ks[0], ks[1], ks[2], ks[3],
      static_cast<const T*>(v), vs[0], vs[1], vs[2], vs[3],
      static_cast<T*>(o), os[0], os[1], os[2], os[3],
      Hq / Hkv, Sq, Sk, q_offset, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype 0 = f32, 1 = bf16; strides are 4 elements each, in (B, H, S, D)
// order; window <= 0 means none.  Returns 0 on success, a cudaError_t
// code if the launch failed, and -1 when (dtype, D) has no instance.
extern "C" int flash_attention(int dtype, int D, const void* q,
                               const long long* q_strides, const void* k,
                               const long long* k_strides, const void* v,
                               const long long* v_strides, void* o,
                               const long long* o_strides, int B, int Hq,
                               int Hkv, int Sq, int Sk, int q_offset,
                               int causal, int window, float scale,
                               void* stream) {
#define FLASH_INSTANCE(CODE, T, HD)                                          \
  if (dtype == CODE && D == HD)                                              \
    return (int)launch<T, HD>(q, q_strides, k, k_strides, v, v_strides, o,   \
                              o_strides, B, Hq, Hkv, Sq, Sk, q_offset,       \
                              causal, window, scale,                         \
                              static_cast<cudaStream_t>(stream));
#define FLASH_DIMS(CODE, T)                                                  \
  FLASH_INSTANCE(CODE, T, 16)                                                \
  FLASH_INSTANCE(CODE, T, 32)                                                \
  FLASH_INSTANCE(CODE, T, 64)                                                \
  FLASH_INSTANCE(CODE, T, 128)                                               \
  FLASH_INSTANCE(CODE, T, 256)
  FLASH_DIMS(0, float)
  FLASH_DIMS(1, __nv_bfloat16)
#undef FLASH_DIMS
#undef FLASH_INSTANCE
  return -1;
}
