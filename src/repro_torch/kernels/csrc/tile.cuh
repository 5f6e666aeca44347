// Shared pieces of the port's GEMM kernels (iaat_gemm.cu, grouped_gemm.cu,
// cx_gemm.cu): the accumulator types, the strided, bounds-checked,
// zero-filling tile loader, and the K loop of one (BM x BN) output block
// on CUDA cores (block_product); the asynchronous K loop (ring_product: a
// cp.async ring of 16-byte copies) and its bf16 tensor-core form
// (ring_mma_product: mma.sync m16n8k16 with the operands swapped, so that
// a group's few rows sit on the mma's 8-column side); and the one-launch
// fix-up of a K split (slice_span, split_reduce).  The IAAT kernel runs
// block_product and ring_product, the grouped kernels all three loops;
// both split K through split_reduce.  flash_attention.cu uses only the
// widen/narrow conversions.
//
// Thread layout (256 threads): each thread owns TM rows x TN = 4 columns
// of the block, bn/4 threads across a row (core/vmem.py::thread_layout_ok
// is the Python side of the same rule).  Shared memory holds one
// (BK x BM) tile of op(A) and one (BK x BN) tile of op(B), rows padded by
// 4 bytes so a column spreads over the 32 banks.  The tensor-core loop
// has a warp layout of its own (MmaLayout).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

// the per-letter objects each use only some of the overloads below
#pragma nv_diag_suppress 177

namespace iaat {

constexpr int NT = 256;   // threads per block (vmem.NTHREADS)
constexpr int TN = 4;     // columns per thread

template <typename T> struct AccOf;
template <> struct AccOf<float> { typedef float type; };
template <> struct AccOf<double> { typedef double type; };
template <> struct AccOf<__nv_bfloat16> { typedef float type; };

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ double widen(double x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T narrow(typename AccOf<T>::type x);
template <> __device__ __forceinline__ float narrow<float>(float x) { return x; }
template <> __device__ __forceinline__ double narrow<double>(double x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T> __host__ __device__ constexpr int pad_of() {
  return sizeof(T) >= 4 ? 1 : 4 / (int)sizeof(T);   // vmem.pad
}

template <int BM, int BN> struct Layout {
  static constexpr int TM = BM * BN / (NT * TN);   // rows per thread
  static constexpr int TX = BN / TN;               // threads across a row
  static constexpr int TY = NT / TX;               // thread rows
  static_assert(BM * BN % (NT * TN) == 0 && NT % TX == 0, "thread layout");
  static_assert(TY * TM == BM, "thread layout");
};

// Dynamic shared memory of one (BM, BN, BK) block.
template <typename T, int BM, int BN, int BK>
constexpr size_t smem_bytes() {
  return (size_t)BK * ((BM + pad_of<T>()) + (BN + pad_of<T>())) * sizeof(T);
}

// Stage tile[k][j] = X[j0 + j, k0 + k] (zero outside J x K), X addressed
// through strides (s_j, s_k).  Consecutive threads walk the unit-stride
// dim so the global loads coalesce whatever the operand's layout.
template <typename T, int W, int BK, int LD>
__device__ __forceinline__ void load_tile(T* __restrict__ tile,
                                          const T* __restrict__ x,
                                          int64_t s_j, int64_t s_k,
                                          int j0, int J, int k0, int K) {
  const T z = narrow<T>(typename AccOf<T>::type(0));
  if (s_k == 1 && s_j != 1) {
    for (int e = threadIdx.x; e < W * BK; e += NT) {
      const int k = e % BK, j = e / BK;
      const int jg = j0 + j, kg = k0 + k;
      tile[k * LD + j] = (jg < J && kg < K) ? x[(int64_t)jg * s_j + kg] : z;
    }
  } else {
    for (int e = threadIdx.x; e < W * BK; e += NT) {
      const int j = e % W, k = e / W;
      const int jg = j0 + j, kg = k0 + k;
      tile[k * LD + j] =
          (jg < J && kg < K) ? x[(int64_t)jg * s_j + (int64_t)kg * s_k] : z;
    }
  }
}

// acc[i][j] = sum_k A[m0 + ty + i*TY, k] * B[k, n0 + tx + j*TX] over the
// whole K, with A (M x K) and B (K x N) read through their strides and
// zero outside their extents.  A loop over K inside the block takes the
// place of the TPU's sequential K grid axis.  smem_raw holds smem_bytes().
template <typename T, int BM, int BN, int BK>
__device__ __forceinline__ void block_product(
    typename AccOf<T>::type (&acc)[Layout<BM, BN>::TM][TN],
    unsigned char* smem_raw,
    const T* __restrict__ A, int64_t a_sm, int64_t a_sk,
    const T* __restrict__ B, int64_t b_sk, int64_t b_sn,
    int m0, int M, int n0, int N, int K) {
  typedef typename AccOf<T>::type Acc;
  typedef Layout<BM, BN> L;
  constexpr int PAD = pad_of<T>();
  constexpr int LDA = BM + PAD, LDB = BN + PAD;
  T* As = reinterpret_cast<T*>(smem_raw);   // [BK][LDA]
  T* Bs = As + BK * LDA;                    // [BK][LDB]
  const int tx = threadIdx.x % L::TX, ty = threadIdx.x / L::TX;

#pragma unroll
  for (int i = 0; i < L::TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = Acc(0);

  for (int k0 = 0; k0 < K; k0 += BK) {
    load_tile<T, BM, BK, LDA>(As, A, a_sm, a_sk, m0, M, k0, K);
    load_tile<T, BN, BK, LDB>(Bs, B, b_sn, b_sk, n0, N, k0, K);
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
      Acc av[L::TM], bv[TN];
#pragma unroll
      for (int i = 0; i < L::TM; ++i) av[i] = widen(As[k * LDA + ty + i * L::TY]);
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = widen(Bs[k * LDB + tx + j * L::TX]);
#pragma unroll
      for (int i = 0; i < L::TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fma(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// O[m, n] = acc, cast once, for the rows m < M and columns n < N of the
// block at (m0, n0); O addressed through its strides.
template <typename T, int BM, int BN>
__device__ __forceinline__ void store_block(
    typename AccOf<T>::type (&acc)[Layout<BM, BN>::TM][TN],
    T* __restrict__ O, int64_t o_sm, int64_t o_sn,
    int m0, int M, int n0, int N) {
  typedef Layout<BM, BN> L;
  const int tx = threadIdx.x % L::TX, ty = threadIdx.x / L::TX;
#pragma unroll
  for (int i = 0; i < L::TM; ++i) {
    const int m = m0 + ty + i * L::TY;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * L::TX;
      if (n < N) O[(int64_t)m * o_sm + (int64_t)n * o_sn] = narrow<T>(acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// The asynchronous K loop (iaat_gemm.cu, grouped_gemm.cu).
//
// A ring of STAGES (A, B) tile pairs in shared memory (as many as leave
// room for two blocks an SM, up to 3: vmem.footprint), filled by 16-byte
// cp.async along each operand's unit-stride dim: A (M x K) with k of unit
// stride is staged as BM rows of BK; B (K x N) as BK rows of BN when n has
// unit stride (B_KC false: the NN weights), or as BN rows of BK when k has
// (B_KC true: the tied embed.T).  Every row is padded by one 16-byte chunk,
// so rows stay aligned for the copies and a warp's 16-byte reads down a
// column of rows spread over the banks.  Edges of M, N and K are zero-
// filled through cp.async's source-size operand.  While the block
// multiplies stage t, the copies of the next STAGES - 1 tiles are in
// flight.  The caller guarantees the alignment (iaat_gemm.py and
// grouped_gemm.py choose this path only for operands whose rows are
// 16-byte aligned).
// ---------------------------------------------------------------------------

template <typename T, int BM, int BN, int BK, bool B_KC, bool EXACT = false>
struct Ring {
  static constexpr int V = 16 / (int)sizeof(T);   // elements of one copy
  static constexpr int LDA = BK + V;              // A: BM rows of BK
  static constexpr int LDB = B_KC ? BK + V : BN + V;
  static constexpr int A_ELEMS = BM * LDA;
  // room for either orientation of B (the IAAT kernel's ring, as
  // vmem.ring_stage_bytes sizes it), or for B_KC's own when EXACT (the
  // grouped kernels', which read B one way)
  static constexpr int B_BOTH = BK * (BN + V) > BN * (BK + V)
                                    ? BK * (BN + V) : BN * (BK + V);
  static constexpr int B_ELEMS =
      EXACT ? (B_KC ? BN * (BK + V) : BK * (BN + V)) : B_BOTH;
  static constexpr size_t STAGE_BYTES =
      (size_t)(A_ELEMS + B_ELEMS) * sizeof(T);
  static constexpr int BUDGET = 115712;           // vmem.RING_BUDGET
  static constexpr int STAGES_MAX = 3;            // vmem.RING_STAGES_MAX
  static constexpr int FIT = (int)(BUDGET / STAGE_BYTES);
  // as many stages as leave room for two blocks an SM, at least one
  static constexpr int STAGES =
      FIT < 1 ? 1 : (FIT < STAGES_MAX ? FIT : STAGES_MAX);
  static_assert(STAGE_BYTES <= 232448, "one ring stage must fit 227 KB");
  static constexpr size_t SMEM_BYTES = STAGES * STAGE_BYTES;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

// R rows x C columns of x (row stride s, unit column stride) at rows
// [r0, r0 + R), columns [c0, c0 + C) into tile[r][c] (row stride LD),
// zero past R_end rows and C_end columns.
template <typename T, int R, int C, int LD>
__device__ __forceinline__ void ring_load(T* tile, const T* __restrict__ x,
                                          int64_t s, int r0, int R_end,
                                          int c0, int C_end) {
  constexpr int V = 16 / (int)sizeof(T);
  constexpr int CPR = C / V;
  for (int e = threadIdx.x; e < R * CPR; e += NT) {
    const int r = e / CPR, c = (e % CPR) * V;
    const int rg = r0 + r, cg = c0 + c;
    int n = rg < R_end ? C_end - cg : 0;
    n = n < 0 ? 0 : (n > V ? V : n);
    cp_async16(tile + r * LD + c, n ? x + (int64_t)rg * s + cg : x,
               n * (int)sizeof(T));
  }
}

// N contiguous elements of shared memory, widened (8, 16 or 32 bytes)
template <typename T, int N>
__device__ __forceinline__ void load_widen(typename AccOf<T>::type (&out)[N],
                                           const T* p) {
  constexpr int BYTES = N * (int)sizeof(T);
  static_assert(BYTES % 8 == 0, "vector width");
  alignas(16) T buf[N];
  if constexpr (BYTES % 16 == 0) {
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i)
      reinterpret_cast<uint4*>(buf)[i] = reinterpret_cast<const uint4*>(p)[i];
  } else {
#pragma unroll
    for (int i = 0; i < BYTES / 8; ++i)
      reinterpret_cast<uint2*>(buf)[i] = reinterpret_cast<const uint2*>(p)[i];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = widen(buf[i]);
}

// The column of accumulator j of thread tx: TN contiguous columns when B
// is staged k-major by rows of n (16-byte reads along a row), TX-strided
// columns when staged n-major (a warp reads down consecutive rows).
template <int BM, int BN, bool B_KC>
__device__ __forceinline__ int ring_col(int tx, int j) {
  return B_KC ? tx + j * Layout<BM, BN>::TX : tx * TN + j;
}

// acc[i][j] = sum over k in [k_lo, k_hi) of A[m0 + ty + i TY, k] *
// B[k, n0 + ring_col(tx, j)], A and B addressed through their row strides
// (k of unit stride in A; n, or k when B_KC, in B).  Rows of the block at
// or past M are not multiplied (uniform skip of whole fragment rows).
template <typename T, int BM, int BN, int BK, bool B_KC, bool EXACT = false>
__device__ __forceinline__ void ring_product(
    typename AccOf<T>::type (&acc)[Layout<BM, BN>::TM][TN],
    unsigned char* smem_raw, const T* __restrict__ A, int64_t a_sm,
    const T* __restrict__ B, int64_t b_s, int m0, int M, int n0, int N,
    int k_lo, int k_hi) {
  typedef typename AccOf<T>::type Acc;
  typedef Layout<BM, BN> L;
  typedef Ring<T, BM, BN, BK, B_KC, EXACT> R;
  constexpr int V = R::V, S = R::STAGES;
  T* base = reinterpret_cast<T*>(smem_raw);
  const int tx = threadIdx.x % L::TX, ty = threadIdx.x / L::TX;
  // fragment rows i < live hold a row below M for some thread
  const int live = (M - m0 + L::TY - 1) / L::TY;

#pragma unroll
  for (int i = 0; i < L::TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = Acc(0);

  const int steps = (k_hi - k_lo + BK - 1) / BK;
  auto issue = [&](int step) {
    if (step < steps) {
      T* As = base + (step % S) * (R::A_ELEMS + R::B_ELEMS);
      T* Bs = As + R::A_ELEMS;
      const int k0 = k_lo + step * BK;
      ring_load<T, BM, BK, R::LDA>(As, A, a_sm, m0, M, k0, k_hi);
      if constexpr (B_KC)
        ring_load<T, BN, BK, R::LDB>(Bs, B, b_s, n0, N, k0, k_hi);
      else
        ring_load<T, BK, BN, R::LDB>(Bs, B, b_s, k0, k_hi, n0, N);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) issue(s);

  for (int step = 0; step < steps; ++step) {
    issue(step + S - 1);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(S - 1) : "memory");
    __syncthreads();
    const T* As = base + (step % S) * (R::A_ELEMS + R::B_ELEMS);
    const T* Bs = As + R::A_ELEMS;
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += V) {
      Acc a[L::TM][V], b[V][TN];
#pragma unroll
      for (int i = 0; i < L::TM; ++i)
        if (i < live) load_widen<T, V>(a[i], As + (ty + i * L::TY) * R::LDA + kk);
      if constexpr (B_KC) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          Acc col[V];
          load_widen<T, V>(col, Bs + ring_col<BM, BN, B_KC>(tx, j) * R::LDB + kk);
#pragma unroll
          for (int q = 0; q < V; ++q) b[q][j] = col[q];
        }
      } else {
#pragma unroll
        for (int q = 0; q < V; ++q)
          load_widen<T, TN>(b[q], Bs + (kk + q) * R::LDB + tx * TN);
      }
#pragma unroll
      for (int i = 0; i < L::TM; ++i)
        if (i < live)
#pragma unroll
          for (int q = 0; q < V; ++q)
#pragma unroll
            for (int j = 0; j < TN; ++j)
              acc[i][j] = fma(a[i][q], b[q][j], acc[i][j]);
    }
    __syncthreads();   // the stage is free for the copies of step + S
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: the ring's tiles multiplied by
// mma.sync.m16n8k16 (bf16 products, f32 sums), with the operands swapped.
//
// The block computes out = A B for A (M x K, a group's few rows, k of
// unit stride) and B (K x N, the weights, n of unit stride: the ring's
// B_KC false orientation) as out^T = B^T A^T: the weights' N runs on the
// mma's 16-row side and A's rows on its 8-column side, so at 8 rows (a
// decode group or a ragged tile of 8) no lane multiplies padding.  The
// 8 warps split the block's BN columns into WN strips of MT m16 tiles
// and its BM rows into WM strips of NF n8 fragments.  Fragments come from
// the ring's stages through ldmatrix: B's tile, staged as BK rows of BN
// (k-major, n contiguous), becomes the row-major (n x k) A fragment with
// .trans; A's rows, staged as BM rows of BK (k contiguous), are already
// the column-major (k x rows) B fragment.  The 16-byte row padding of the
// ring keeps both ldmatrix forms free of bank conflicts.  n8 fragments
// wholly past M are neither loaded nor multiplied (uniform per warp);
// the ring zero-fills past M, N and the slice's end of K, as for
// ring_product.
// ---------------------------------------------------------------------------

template <int BM, int BN> struct MmaLayout {
  static constexpr int WN = BN / 16 < NT / 32 ? BN / 16 : NT / 32;
  static constexpr int WM = NT / 32 / WN;      // warps across the rows
  static constexpr int MT = BN / (16 * WN);    // m16 tiles of a warp (N)
  static constexpr int NF = BM / (8 * WM);     // n8 fragments of a warp
  // a thread's accumulators, acc[ROWS][COLS]: two rows of A (2 (lane % 4)
  // and one more) in each n8 fragment, two columns of B (lane / 4 and 8
  // further) in each m16 tile
  static constexpr int ROWS = 2 * NF, COLS = 2 * MT;
  static_assert(WN * WM == NT / 32 && MT * 16 * WN == BN &&
                    NF * 8 * WM == BM && NF >= 1, "mma warp layout");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// (d0, d1, d2, d3) += a b for one m16n8k16 tile: a the row-major
// (16 x 16) fragment, (b0, b1) the column-major (16 x 8) one; d0, d1 at
// the mma's row lane / 4 and columns 2 (lane % 4) + 0, 1, d2, d3 eight
// rows further
__device__ __forceinline__ void mma_bf16(float& d0, float& d1, float& d2,
                                         float& d3, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The block-relative row of A that acc[i][.] of ring_mma_product holds
// (n8 fragment i / 2 of the warp's row strip), and the column of B that
// acc[.][j] holds (m16 tile j / 2 of its column strip).
template <int BM, int BN>
__device__ __forceinline__ int mma_row(int i) {
  typedef MmaLayout<BM, BN> W;
  return (threadIdx.x / 32 / W::WN) * W::NF * 8 + (i >> 1) * 8 +
         (threadIdx.x % 4) * 2 + (i & 1);
}
template <int BM, int BN>
__device__ __forceinline__ int mma_col(int j) {
  typedef MmaLayout<BM, BN> W;
  return (threadIdx.x / 32 % W::WN) * W::MT * 16 + (j >> 1) * 16 +
         threadIdx.x % 32 / 4 + (j & 1) * 8;
}

// acc[i][j] = sum over k in [k_lo, k_hi) of A[mma_row(i), k] B[k, n0 +
// mma_col(j)], A (rows [0, M), k of unit stride, row stride a_sm)
// and B (n of unit stride, row stride b_sk) in bf16, through the ring of
// Ring<.., false, true> (sized for B read along N alone).
template <int BM, int BN, int BK>
__device__ __forceinline__ void ring_mma_product(
    float (&acc)[MmaLayout<BM, BN>::ROWS][MmaLayout<BM, BN>::COLS],
    unsigned char* smem_raw,
    const __nv_bfloat16* __restrict__ A, int64_t a_sm,
    const __nv_bfloat16* __restrict__ B, int64_t b_sk, int M, int n0,
    int N, int k_lo, int k_hi) {
  typedef __nv_bfloat16 T;
  typedef MmaLayout<BM, BN> W;
  typedef Ring<T, BM, BN, BK, false, true> R;
  constexpr int S = R::STAGES;
  static_assert(BK % 32 == 0, "two k16 steps a pass");
  T* base = reinterpret_cast<T*>(smem_raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col0 = (warp % W::WN) * W::MT * 16;   // the warp's N strip
  const int row0 = (warp / W::WN) * W::NF * 8;    // its row strip
  // the warp's n8 fragments that hold a row below M
  const int live = M > row0 ? (M - row0 + 7) / 8 : 0;
  // ldmatrix: lane gives row (lane & 7) of 8 x 8 matrix (lane >> 3)
  const int lr = lane & 7, lq = lane >> 3;

#pragma unroll
  for (int i = 0; i < W::ROWS; ++i)
#pragma unroll
    for (int j = 0; j < W::COLS; ++j) acc[i][j] = 0.f;

  const int steps = (k_hi - k_lo + BK - 1) / BK;
  auto issue = [&](int step) {
    if (step < steps) {
      T* As = base + (step % S) * (R::A_ELEMS + R::B_ELEMS);
      T* Bs = As + R::A_ELEMS;
      const int k0 = k_lo + step * BK;
      ring_load<T, BM, BK, R::LDA>(As, A, a_sm, 0, M, k0, k_hi);
      ring_load<T, BK, BN, R::LDB>(Bs, B, b_sk, k0, k_hi, n0, N);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) issue(s);

  for (int step = 0; step < steps; ++step) {
    issue(step + S - 1);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(S - 1) : "memory");
    __syncthreads();
    const T* As = base + (step % S) * (R::A_ELEMS + R::B_ELEMS);
    const T* Bs = As + R::A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      // the weights' A fragments of two k16 steps: matrix lq is k rows
      // (lq >> 1) * 8.. and n columns (lq & 1) * 8.. of the m16 tile
      uint32_t wa[2][W::MT][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int mt = 0; mt < W::MT; ++mt)
          ldsm_x4_trans(wa[h][mt],
                        Bs + (kk + h * 16 + (lq >> 1) * 8 + lr) * R::LDB +
                            col0 + mt * 16 + (lq & 1) * 8);
#pragma unroll
      for (int nf = 0; nf < W::NF; ++nf) {
        if (nf >= live) break;
        // A's rows as B fragments: matrix lq is k columns kk + 8 lq..
        uint32_t xb[4];
        ldsm_x4(xb, As + (row0 + nf * 8 + lr) * R::LDA + kk + lq * 8);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int mt = 0; mt < W::MT; ++mt)
            mma_bf16(acc[2 * nf][2 * mt], acc[2 * nf + 1][2 * mt],
                     acc[2 * nf][2 * mt + 1], acc[2 * nf + 1][2 * mt + 1],
                     wa[h][mt], xb[2 * h], xb[2 * h + 1]);
      }
    }
    __syncthreads();   // the stage is free for the copies of step + S
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// K split within one launch (iaat_gemm.cu, grouped_gemm.cu).
//
// A grid that underfills the card is cut along K into `slices` (grid
// dim z of the IAAT kernel, folded into x for the grouped ones).  Every
// slice sums its bk steps (slice_span) into an f32 (f64 for D) workspace
// of slices x the output, allocated by the wrapper; the last block of an
// output tile to finish, told by the tile's ticket (an atomicAdd after a
// __threadfence, reset to 0 by that block, so the tickets stay zeroed
// between launches), adds the slices in slice order (deterministic,
// whichever block is last) and goes on to the epilogue: one launch, no
// second reduce kernel.
// ---------------------------------------------------------------------------

// Slice z's K range [k_lo, k_hi): whole BK steps dealt out evenly, the
// first steps % slices slices one step longer (core/plan.py slice_steps).
template <int BK>
__device__ __forceinline__ void slice_span(int K, int slices, int z,
                                           int& k_lo, int& k_hi) {
  const int steps = (K + BK - 1) / BK, lo = steps / slices,
            rem = steps % slices;
  const int s0 = z * lo + min(z, rem), s1 = s0 + lo + (z < rem);
  k_lo = s0 * BK;
  k_hi = min(K, s1 * BK);
}

// Publishes acc[i][j], the tile's output (row(i), col(j)) where row(i) <
// M and col(j) < N, to slice z of the workspace (slice z at ws + z *
// step, output (m, n) at m * N + n), then draws the tile's ticket.
// Returns false in every block of the tile but the last, which the
// caller then ends; in the last, acc holds the sum over the slices, in
// slice order.
template <typename Acc, int I, int J, typename Row, typename Col>
__device__ __forceinline__ bool split_reduce(Acc (&acc)[I][J],
                                             Acc* __restrict__ ws,
                                             int64_t step, int M, int N,
                                             unsigned int* ticket,
                                             int slices, int z, Row row,
                                             Col col) {
  __shared__ int last;
  Acc* w = ws + (int64_t)z * step;
#pragma unroll
  for (int i = 0; i < I; ++i) {
    const int m = row(i);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int n = col(j);
      if (n < N) w[(int64_t)m * N + n] = acc[i][j];
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(ticket, 1u) == (unsigned int)(slices - 1);
    if (last) *ticket = 0u;   // every slice has arrived: ready for reuse
  }
  __syncthreads();
  if (!last) return false;
  __threadfence();
#pragma unroll
  for (int i = 0; i < I; ++i) {
    const int m = row(i);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int n = col(j);
      if (n >= N) continue;
      // eight loads in flight at a time, added in slice order
      const Acc* src = ws + (int64_t)m * N + n;
      Acc s = Acc(0);
      int q = 0;
      for (; q + 8 <= slices; q += 8) {
        Acc v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) v[u] = __ldcg(src + (q + u) * step);
#pragma unroll
        for (int u = 0; u < 8; ++u) s += v[u];
      }
      for (; q < slices; ++q) s += __ldcg(src + q * step);
      acc[i][j] = s;
    }
  }
  return true;
}

}  // namespace iaat

// The element type of the letter a per-letter object is built for
// (-DIAAT_LETTER=0 S, 1 D, 2 H, 3 C, 4 Z; for C and Z the type of one
// plane, float and double), and its generated instance list.
#ifdef IAAT_LETTER
#if IAAT_LETTER == 0
typedef float Elem;
#define IAAT_TABLE "iaat_table_S.inc"
#define IAAT_NAME(base) base##_S
#elif IAAT_LETTER == 1
typedef double Elem;
#define IAAT_TABLE "iaat_table_D.inc"
#define IAAT_NAME(base) base##_D
#elif IAAT_LETTER == 2
typedef __nv_bfloat16 Elem;
#define IAAT_TABLE "iaat_table_H.inc"
#define IAAT_NAME(base) base##_H
#elif IAAT_LETTER == 3
typedef float Elem;
#define IAAT_TABLE "iaat_table_C.inc"
#define IAAT_NAME(base) base##_C
#elif IAAT_LETTER == 4
typedef double Elem;
#define IAAT_TABLE "iaat_table_Z.inc"
#define IAAT_NAME(base) base##_Z
#else
#error "IAAT_LETTER must be 0 (S), 1 (D), 2 (H), 3 (C) or 4 (Z)"
#endif
#endif  // IAAT_LETTER
