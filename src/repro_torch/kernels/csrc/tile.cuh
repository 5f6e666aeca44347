// Shared pieces of the port's GEMM kernels (iaat_gemm.cu, grouped_gemm.cu,
// cx_gemm.cu): the accumulator types, the strided, bounds-checked,
// zero-filling tile loader, and the K loop of one (BM x BN) output block
// on CUDA cores.  flash_attention.cu uses only the widen/narrow
// conversions.
//
// Thread layout (256 threads): each thread owns TM rows x TN = 4 columns
// of the block, bn/4 threads across a row (core/vmem.py::thread_layout_ok
// is the Python side of the same rule).  Shared memory holds one
// (BK x BM) tile of op(A) and one (BK x BN) tile of op(B), rows padded by
// 4 bytes so a column spreads over the 32 banks.
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
