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
// (989 TFLOP/s bf16 on the tensor cores).  Two kernels, chosen by
// (dtype, head dim) in the C entry, never on failure:
//
// A. flash_attention_tc_kernel: bf16 at D 64, 128 and 256 (olmo-1b's and
//    gemma3's head dims).  Both products run on Hopper's tensor cores
//    (wgmma m64n64k16, f32 accumulators):
//   * a block owns BQ = 128 query rows of one (batch, head), two consumer
//     warpgroups of 64 rows each (256 threads); its kv head is
//     head / (Hq / Hkv), so GQA never repeats K or V in memory;
//   * Q stays in shared memory for the whole KV loop; K and V tiles of
//     BKV = 64 keys arrive through a 2-stage ring filled with 16-byte
//     cp.async (zero-filled past Sq and Sk), the next tile's copies in
//     flight while the current one is multiplied;
//   * every tile is stored as 64-column slabs of 128-byte rows in the
//     128-byte swizzle wgmma's descriptors read: Q and K as K-major
//     operands of S = Q K^T, V as the MN-major B operand of O += P V, so
//     no transpose copy is made;
//   * P feeds P V from registers: the S accumulator's fragment is the A
//     fragment.  p is split into three bf16 terms, hi = bf16(p), mid =
//     bf16(p - hi), lo = bf16(p - hi - mid), which add up to the f32 p
//     exactly, and all three are multiplied (three wgmmas), so the
//     products with bf16 V stay exact: the reference's f32 P V, not a
//     bf16-rounded one.  Two terms (p within ~2^-17) are not enough: on
//     outputs near 0 (cancellation) their error passes the check's 1e-6
//     floor (DESIGN_PORT.md §8);
//   * causal: KV tiles past the block's last query are never loaded, and
//     only tiles that cross a mask edge take the per-element mask; the
//     grid puts the query block on its slowest axis, last blocks first,
//     so the longest blocks start first;
//   * shared memory 128 D + 4 x 64 D bf16 (+ 1 KB alignment slack):
//     50,176 B at D 64, 99,328 at D 128, 197,632 at D 256.
//
// B. flash_attention_kernel: f32 at every head dim and bf16 at D 16 and
//    32, the first port's kernel.  Its products are f32 FMAs on the CUDA
//    cores (67 TFLOP/s peak, less here because its inner loops feed from
//    shared memory): f32 must not become TF32 (ROADMAP.md's numerics
//    rule), and D 16/32 are under wgmma's k16 x 4 swizzle slab.  What
//    its design does about the bytes: each K/V element is read from HBM
//    once per block of BQ query rows (the q tile stays in shared memory
//    for the whole KV loop), and the KV tiles that the causal or the
//    window mask rules out are never loaded.
//
// Design of B (per CUDA block, NT = 128 threads; grid (ceil(Sq/BQ), Hq, B)):
//   * the block owns BQ = 32 query rows of one (batch, head);
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
//     each thread owns D/4 columns of the row's f32 accumulator.
// Both kernels: masks per element as the TPU kernel's: ki < Sk, causal
// ki <= qi, window ki > qi - window (qi offset by q_offset).  Masked
// scores take the finite NEG_INF = -1e30 and their probabilities are
// zeroed, so a row with no valid key ends with l = 0 and writes 0, never
// NaN; the output is acc / max(l, 1e-37), cast once to q's dtype.
// Shared memory of B is (BQ + 2 BKV)(D + 1) + BQ (BKV + 1) floats, rows
// padded by one float against bank conflicts: 53,760 bytes at D = 128 and
// 102,912 at D = 256, so those launches opt in to dynamic shared memory
// above 48 KB.
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


// ---------------------------------------------------------------------------
// A. The tensor-core kernel (bf16, D 64/128/256).
// ---------------------------------------------------------------------------

namespace tc {

typedef __nv_bfloat16 bf16;

constexpr int NT = 256;     // two consumer warpgroups
constexpr int BQ = 128;     // query rows per block, 64 per warpgroup
constexpr int BKV = 64;     // keys per KV tile
constexpr int ROW = 128;    // bytes of one swizzled slab row (64 bf16)

template <int D>
struct Smem {
  static constexpr uint32_t Q = BQ * D * 2;     // the Q tile
  static constexpr uint32_t KV = BKV * D * 2;   // one K or V tile
  // Q, two stages of (K, V), and slack to align the base to 1024 bytes
  static constexpr size_t bytes = Q + 4 * KV + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma matrix descriptor of a 128-byte-swizzled operand at `addr`:
// leading byte offset `lbo`, stride byte offset `sbo` (8-row groups).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// Rows [r0, r0 + ROWS) x D of a bf16 matrix (row stride s elements, unit
// column stride) into D/64 slabs of ROWS x 128 bytes at dst, each 16-byte
// chunk c of row r at chunk (c ^ r % 8) (the 128-byte swizzle); rows at
// or past R are zero-filled (cp.async's source size 0).
template <int ROWS, int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          int64_t s, int r0, int R) {
  constexpr int CPR = D / 8;   // 16-byte chunks per row
  for (int e = threadIdx.x; e < ROWS * CPR; e += NT) {
    const int r = e / CPR, c = e % CPR, rg = r0 + r;
    const uint32_t off = (c / 8) * (ROWS * ROW) + r * ROW +
                         (((c % 8) ^ (r % 8)) * 16);
    const bool in = rg < R;
    const bf16* g = in ? src + (int64_t)rg * s + c * 8 : src;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     dst + off),
                 "l"(g), "r"(in ? 16 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accesses of d across the async products
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64, f32) (+)= A (64 x 16) B (16 x 64), both from shared memory,
// K-major; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, f32) += A (64 x 16, bf16 pairs in registers) B (16 x 64),
// B MN-major in shared memory (imm-trans-b 1).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_attention_tc_kernel(const bf16* __restrict__ Q, int64_t q_sb,
                          int64_t q_sh, int64_t q_ss,
                          const bf16* __restrict__ K, int64_t k_sb,
                          int64_t k_sh, int64_t k_ss,
                          const bf16* __restrict__ V, int64_t v_sb,
                          int64_t v_sh, int64_t v_ss,
                          bf16* __restrict__ O, int64_t o_sb, int64_t o_sh,
                          int64_t o_ss, int64_t o_sd, int rep, int Sq, int Sk,
                          int q_offset, int causal, int window, float scale) {
  constexpr int NC = D / 64;     // 64-column chunks of the head dim
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sKV = sQ + Smem<D>::Q;   // stage st: K, then V

  // the last query blocks (the most keys under a causal mask) first
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int64_t h = blockIdx.x, b = blockIdx.y, hk = h / rep;
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32;
  const int g = (tid % 32) / 4, t = tid % 4;
  const bf16* k = K + b * k_sb + hk * k_sh;
  const bf16* v = V + b * v_sb + hk * v_sh;

  const int q_start = q0 + q_offset;
  int kv_begin = 0, kv_end = Sk;
  if (causal) kv_end = min(Sk, q_start + BQ);
  if (window > 0) kv_begin = max(0, q_start - window + 1) / BKV * BKV;
  // this thread's two rows (fragment rows g and g + 8 of its warp) and
  // its warpgroup's first and last query, all as absolute positions
  const int row = wg * 64 + warp * 16 + g;
  const int qi_lo = q_start + row, qi_hi = qi_lo + 8;
  const int wq_first = q_start + wg * 64, wq_last = wq_first + 63;

  load_tile<BQ, D>(sQ, Q + b * q_sb + h * q_sh, q_ss, q0, Sq);
  if (kv_begin < kv_end) {
    load_tile<BKV, D>(sKV, k, k_ss, kv_begin, Sk);
    load_tile<BKV, D>(sKV + Smem<D>::KV, v, v_ss, kv_begin, Sk);
  }
  cp_commit();

  float o[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float m_lo = NEG_INF, m_hi = NEG_INF, l_lo = 0.f, l_hi = 0.f;

  int stage = 0;
  for (int k0 = kv_begin; k0 < kv_end; k0 += BKV, stage ^= 1) {
    const uint32_t sK = sKV + stage * 2 * Smem<D>::KV;
    const uint32_t sV = sK + Smem<D>::KV;
    if (k0 + BKV < kv_end) {   // the next tile, into the other stage
      const uint32_t nK = sKV + (stage ^ 1) * 2 * Smem<D>::KV;
      load_tile<BKV, D>(nK, k, k_ss, k0 + BKV, Sk);
      load_tile<BKV, D>(nK + Smem<D>::KV, v, v_ss, k0 + BKV, Sk);
    }
    cp_commit();
    cp_wait<1>();   // this tile (and Q) landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    // S = Q K^T over D in k16 steps: 4 steps per 64-column slab
    float s[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss(s,
               desc(sQ + (kk / 4) * (BQ * ROW) + wg * (64 * ROW) + off, 16,
                    1024),
               desc(sK + (kk / 4) * (BKV * ROW) + off, 16, 1024), kk > 0);
    }
    wg_commit();
    wg_wait();
    fence_regs(s);

    // scale, mask (only tiles that cross a mask edge), row max
    const bool full = k0 + BKV <= Sk &&
                      (!causal || k0 + BKV - 1 <= wq_first) &&
                      (window <= 0 || k0 > wq_last - window);
    uint32_t ok = 0xffffffffu;
    float mx_lo = NEG_INF, mx_hi = NEG_INF;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i] * scale;
      if (!full) {
        const int ki = k0 + 8 * (i / 4) + 2 * t + (i & 1);
        const int qi = (i & 2) ? qi_hi : qi_lo;
        const bool valid = ki < Sk && (!causal || ki <= qi) &&
                           (window <= 0 || ki > qi - window);
        if (!valid) {
          x = NEG_INF;
          ok &= ~(1u << i);
        }
      }
      s[i] = x;
      if (i & 2) mx_hi = fmaxf(mx_hi, x); else mx_lo = fmaxf(mx_lo, x);
    }
    // a row's 64 scores sit in the 4 lanes of one quad
#pragma unroll
    for (int w = 1; w <= 2; w <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, w));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, w));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    float ps_lo = 0.f, ps_hi = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = (ok >> i & 1u) ? expf(s[i] - ((i & 2) ? mn_hi : mn_lo))
                                     : 0.f;
      s[i] = p;
      if (i & 2) ps_hi += p; else ps_lo += p;
    }
#pragma unroll
    for (int w = 1; w <= 2; w <<= 1) {
      ps_lo += __shfl_xor_sync(0xffffffffu, ps_lo, w);
      ps_hi += __shfl_xor_sync(0xffffffffu, ps_hi, w);
    }
    const float c_lo = expf(m_lo - mn_lo), c_hi = expf(m_hi - mn_hi);
    l_lo = l_lo * c_lo + ps_lo;
    l_hi = l_hi * c_hi + ps_hi;
    m_lo = mn_lo;
    m_hi = mn_hi;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] *= (i & 2) ? c_hi : c_lo;

    // P as A fragments, split into three bf16 terms that add up to the
    // f32 p exactly: hi = bf16(p), mid = bf16(p - hi), lo = bf16(p - hi -
    // mid) (each difference is exact in f32).  k16 step kk takes the
    // scores of keys 16 kk .. 16 kk + 15, s[8 kk .. 8 kk + 7].
    uint32_t ph[4][4], pm[4][4], pl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p0 = s[8 * kk + 2 * r], p1 = s[8 * kk + 2 * r + 1];
        const bf16 h0 = __float2bfloat16_rn(p0), h1 = __float2bfloat16_rn(p1);
        const float r0 = p0 - __bfloat162float(h0),
                    r1 = p1 - __bfloat162float(h1);
        const bf16 m0 = __float2bfloat16_rn(r0), m1 = __float2bfloat16_rn(r1);
        ph[kk][r] = pack(h0, h1);
        pm[kk][r] = pack(m0, m1);
        pl[kk][r] = pack(__float2bfloat16_rn(r0 - __bfloat162float(m0)),
                         __float2bfloat16_rn(r1 - __bfloat162float(m1)));
      }

    // O += P V as hi V + mid V + lo V; V's 16-key step is 16 rows of 128
    // bytes
#pragma unroll
    for (int c = 0; c < NC; ++c) fence_regs(o[c]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const uint64_t dv = desc(sV + c * (BKV * ROW) + kk * 16 * ROW,
                                 BKV * ROW, 1024);
        wgmma_rs(o[c], ph[kk], dv);
        wgmma_rs(o[c], pm[kk], dv);
        wgmma_rs(o[c], pl[kk], dv);
      }
    wg_commit();
    wg_wait();
#pragma unroll
    for (int c = 0; c < NC; ++c) fence_regs(o[c]);
    __syncthreads();   // both warpgroups are done with this stage
  }
  cp_wait<0>();

  const float d_lo = fmaxf(l_lo, 1e-37f), d_hi = fmaxf(l_hi, 1e-37f);
  bf16* out = O + b * o_sb + h * o_sh;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = q0 + row + ((i & 2) ? 8 : 0);
    if (r >= Sq) continue;
    const float den = (i & 2) ? d_hi : d_lo;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = c * 64 + 8 * (i / 4) + 2 * t + (i & 1);
      out[(int64_t)r * o_ss + (int64_t)col * o_sd] =
          __float2bfloat16_rn(o[c][i] / den);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const long long* qs, const void* k,
                   const long long* ks, const void* v, const long long* vs,
                   void* o, const long long* os, int B, int Hq, int Hkv,
                   int Sq, int Sk, int q_offset, int causal, int window,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = Smem<D>::bytes;
  void (*kern)(const bf16*, int64_t, int64_t, int64_t, const bf16*, int64_t,
               int64_t, int64_t, const bf16*, int64_t, int64_t, int64_t,
               bf16*, int64_t, int64_t, int64_t, int64_t, int, int, int, int,
               int, int, float) = flash_attention_tc_kernel<D>;
  // opt in to dynamic shared memory above 48 KB, once per instance
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid(Hq, B, (Sq + BQ - 1) / BQ);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const bf16*>(q), qs[0], qs[1], qs[2],
      static_cast<const bf16*>(k), ks[0], ks[1], ks[2],
      static_cast<const bf16*>(v), vs[0], vs[1], vs[2],
      static_cast<bf16*>(o), os[0], os[1], os[2], os[3], Hq / Hkv, Sq, Sk,
      q_offset, causal, window, scale);
  return cudaGetLastError();
}

// The kernel's operand contract: unit stride along D, every row (and the
// base) 16-byte aligned, so that each 16-byte cp.async is one aligned
// chunk of a row.
bool operand_ok(const void* p, const long long* s) {
  return s[3] == 1 && reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         s[0] % 8 == 0 && s[1] % 8 == 0 && s[2] % 8 == 0;
}

}  // namespace tc

}  // namespace

// dtype 0 = f32, 1 = bf16; strides are 4 elements each, in (B, H, S, D)
// order; window <= 0 means none.  bf16 at D 64, 128 and 256 runs the
// tensor-core kernel (its q, k and v must have a unit stride along D and
// 16-byte-aligned rows: -2 otherwise), everything else the CUDA-core
// kernel.  Returns 0 on success, a cudaError_t code if the launch failed,
// and -1 when (dtype, D) has no instance.
extern "C" int flash_attention(int dtype, int D, const void* q,
                               const long long* q_strides, const void* k,
                               const long long* k_strides, const void* v,
                               const long long* v_strides, void* o,
                               const long long* o_strides, int B, int Hq,
                               int Hkv, int Sq, int Sk, int q_offset,
                               int causal, int window, float scale,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && (D == 64 || D == 128 || D == 256)) {
    if (!tc::operand_ok(q, q_strides) || !tc::operand_ok(k, k_strides) ||
        !tc::operand_ok(v, v_strides))
      return -2;
#define FLASH_TC(HD)                                                          \
  if (D == HD)                                                                \
    return (int)tc::launch<HD>(q, q_strides, k, k_strides, v, v_strides, o,   \
                               o_strides, B, Hq, Hkv, Sq, Sk, q_offset,       \
                               causal, window, scale, st);
    FLASH_TC(64)
    FLASH_TC(128)
    FLASH_TC(256)
#undef FLASH_TC
  }
#define FLASH_INSTANCE(CODE, T, HD)                                          \
  if (dtype == CODE && D == HD)                                              \
    return (int)launch<T, HD>(q, q_strides, k, k_strides, v, v_strides, o,   \
                              o_strides, B, Hq, Hkv, Sq, Sk, q_offset,       \
                              causal, window, scale, st);
  FLASH_INSTANCE(0, float, 16)
  FLASH_INSTANCE(0, float, 32)
  FLASH_INSTANCE(0, float, 64)
  FLASH_INSTANCE(0, float, 128)
  FLASH_INSTANCE(0, float, 256)
  FLASH_INSTANCE(1, __nv_bfloat16, 16)
  FLASH_INSTANCE(1, __nv_bfloat16, 32)
#undef FLASH_INSTANCE
  return -1;
}
