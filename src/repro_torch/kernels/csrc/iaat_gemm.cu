// IAAT GEMM region kernel for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel repro/kernels/iaat_gemm.py::_real_body (called
// through _real_call): C = alpha * op(A) @ op(B) + beta * C for one plan
// region, letters S (f32), D (f64) and H (bf16).
//
// What bounds it on an H100: on the main path (decode M=4 and prefill
// M=32 against 2048..50304-wide weights) the product does 4..32 flops per
// byte of B, far under the bf16 ridge of ~295, so it is bound by the
// bytes of B streamed from HBM, not by operations.  What the design does
// about that: every byte of A and B is read from global memory once per
// C block, in the operand's stored layout (the loader walks whichever
// dim has unit stride, so the tied embed.T and the four transpositions
// all load coalesced, with no pack copy); blocks are wide in N so the
// per-block A re-reads stay small.  It does not yet pipeline its loads
// (no cp.async/TMA ring) or use tensor cores: a simple kernel that is
// right comes first, and later PRs make it fast.
//
// Design (per CUDA block, 256 threads):
//   * one block per (BM x BN) output tile; a loop over K inside the block
//     replaces the TPU's sequential K grid axis;
//   * per K step, one (BK x BM) tile of op(A) and one (BK x BN) tile of
//     op(B) are staged in shared memory (rows padded by 4 bytes);
//   * loads are bounds-checked and zero-filled on M, N and K, which
//     replaces the TPU kernel's iota K mask and its clipped M/N stores,
//     and keeps NaN garbage out of the sums;
//   * each thread accumulates TM x 4 outputs in f32 (S, H) or f64 (D);
//   * epilogue as templates.epilogue_axpby: alpha*acc + beta*C in the
//     accumulator type, then one cast, stored through C's strides.
//
// Built by repro_torch/kernels/build.py: one object per letter
// (-DIAAT_LETTER=0 S, 1 D, 2 H), each including the generated list of
// (BM, BN, BK) instances of that letter, "iaat_table_<letter>.inc".

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

// the per-letter objects each use only some of the overloads below
#pragma nv_diag_suppress 177

namespace {

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

template <typename T, int BM, int BN, int BK>
__global__ void __launch_bounds__(NT)
iaat_gemm_kernel(const T* __restrict__ A, int64_t a_sm, int64_t a_sk,
                 const T* __restrict__ B, int64_t b_sk, int64_t b_sn,
                 const T* __restrict__ C, int64_t c_sm, int64_t c_sn,
                 T* __restrict__ O, int64_t o_sm, int64_t o_sn,
                 int M, int N, int K, double alpha, double beta) {
  typedef typename AccOf<T>::type Acc;
  constexpr int PAD = pad_of<T>();
  constexpr int LDA = BM + PAD, LDB = BN + PAD;
  constexpr int TM = BM * BN / (NT * TN);   // rows per thread
  constexpr int TX = BN / TN;               // threads across a row
  constexpr int TY = NT / TX;               // thread rows
  static_assert(BM * BN % (NT * TN) == 0 && NT % TX == 0, "thread layout");
  static_assert(TY * TM == BM, "thread layout");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);   // [BK][LDA]
  T* Bs = As + BK * LDA;                    // [BK][LDB]

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  Acc acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = Acc(0);

  for (int k0 = 0; k0 < K; k0 += BK) {
    load_tile<T, BM, BK, LDA>(As, A, a_sm, a_sk, m0, M, k0, K);
    load_tile<T, BN, BK, LDB>(Bs, B, b_sn, b_sk, n0, N, k0, K);
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
      Acc av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = widen(As[k * LDA + ty + i * TY]);
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = widen(Bs[k * LDB + tx + j * TX]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fma(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  const Acc al = Acc(alpha), be = Acc(beta);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + i * TY;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * TX;
      if (n >= N) continue;
      Acc v = al * acc[i][j];
      if (C != nullptr) v = v + be * widen(C[(int64_t)m * c_sm + (int64_t)n * c_sn]);
      O[(int64_t)m * o_sm + (int64_t)n * o_sn] = narrow<T>(v);
    }
  }
}

template <typename T, int BM, int BN, int BK>
cudaError_t launch(const void* a, int64_t a_sm, int64_t a_sk,
                   const void* b, int64_t b_sk, int64_t b_sn,
                   const void* c, int64_t c_sm, int64_t c_sn,
                   void* o, int64_t o_sm, int64_t o_sn,
                   int M, int N, int K, double alpha, double beta,
                   cudaStream_t stream) {
  constexpr int PAD = pad_of<T>();
  constexpr size_t smem = (size_t)BK * ((BM + PAD) + (BN + PAD)) * sizeof(T);
  void (*kern)(const T*, int64_t, int64_t, const T*, int64_t, int64_t,
               const T*, int64_t, int64_t, T*, int64_t, int64_t,
               int, int, int, double, double) = iaat_gemm_kernel<T, BM, BN, BK>;
  if (smem > 48 * 1024) {
    // opt in to dynamic shared memory above 48 KB, once per instance
    static const cudaError_t attr = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return attr;
  }
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(a), a_sm, a_sk, static_cast<const T*>(b), b_sk, b_sn,
      static_cast<const T*>(c), c_sm, c_sn, static_cast<T*>(o), o_sm, o_sn,
      M, N, K, alpha, beta);
  return cudaGetLastError();
}

}  // namespace

#if IAAT_LETTER == 0
typedef float Elem;
#define IAAT_FN iaat_gemm_S
#define IAAT_TABLE "iaat_table_S.inc"
#elif IAAT_LETTER == 1
typedef double Elem;
#define IAAT_FN iaat_gemm_D
#define IAAT_TABLE "iaat_table_D.inc"
#elif IAAT_LETTER == 2
typedef __nv_bfloat16 Elem;
#define IAAT_FN iaat_gemm_H
#define IAAT_TABLE "iaat_table_H.inc"
#else
#error "IAAT_LETTER must be 0 (S), 1 (D) or 2 (H)"
#endif

// Returns 0 on success, a cudaError_t code if the launch failed, and -1
// when (bm, bn, bk) is not an instance of the installed table.
extern "C" int IAAT_FN(int bm, int bn, int bk,
                       const void* a, long long a_sm, long long a_sk,
                       const void* b, long long b_sk, long long b_sn,
                       const void* c, long long c_sm, long long c_sn,
                       void* o, long long o_sm, long long o_sn,
                       int M, int N, int K, double alpha, double beta,
                       void* stream) {
#define IAAT_INSTANCE(BM, BN, BK)                                          \
  if (bm == BM && bn == BN && bk == BK)                                    \
    return (int)launch<Elem, BM, BN, BK>(a, a_sm, a_sk, b, b_sk, b_sn, c,  \
                                         c_sm, c_sn, o, o_sm, o_sn, M, N,  \
                                         K, alpha, beta,                   \
                                         static_cast<cudaStream_t>(stream));
#include IAAT_TABLE
#undef IAAT_INSTANCE
  return -1;
}

#if IAAT_LETTER == 0
extern "C" const char* iaat_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
#endif
