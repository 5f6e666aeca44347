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
// Design (per CUDA block, 256 threads; the K loop is tile.cuh's
// block_product, shared with grouped_gemm.cu):
//   * one block per (BM x BN) output tile; a loop over K inside the block
//     replaces the TPU's sequential K grid axis;
//   * per K step, one (BK x BM) tile of op(A) and one (BK x BN) tile of
//     op(B) are staged in shared memory (rows padded by 4 bytes);
//   * loads are bounds-checked and zero-filled on M, N and K, which
//     replaces the TPU kernel's iota K mask and its clipped M/N stores,
//     and keeps NaN garbage out of the sums;
//   * each thread accumulates TM x 4 outputs in f32 (S, H) or f64 (D);
//   * epilogue as templates.epilogue_axpby: alpha*acc + beta*C in the
//     accumulator type, then one cast, stored through C's strides.  C is
//     read in the accumulator type (f32 for S and H, f64 for D): the
//     wrapper casts a C of any other dtype to it, so an f32 C of an H
//     GEMM is never rounded through bf16.
//
// Built by repro_torch/kernels/build.py: one object per letter
// (-DIAAT_LETTER=0 S, 1 D, 2 H), each including the generated list of
// (BM, BN, BK) instances of that letter, "iaat_table_<letter>.inc".

#include "tile.cuh"

namespace {

using namespace iaat;

template <typename T, int BM, int BN, int BK>
__global__ void __launch_bounds__(NT)
iaat_gemm_kernel(const T* __restrict__ A, int64_t a_sm, int64_t a_sk,
                 const T* __restrict__ B, int64_t b_sk, int64_t b_sn,
                 const typename AccOf<T>::type* __restrict__ C, int64_t c_sm,
                 int64_t c_sn, T* __restrict__ O, int64_t o_sm, int64_t o_sn,
                 int M, int N, int K, double alpha, double beta) {
  typedef typename AccOf<T>::type Acc;
  typedef Layout<BM, BN> L;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  Acc acc[L::TM][TN];
  block_product<T, BM, BN, BK>(acc, smem_raw, A, a_sm, a_sk, B, b_sk, b_sn,
                               m0, M, n0, N, K);

  const int tx = threadIdx.x % L::TX, ty = threadIdx.x / L::TX;
  const Acc al = Acc(alpha), be = Acc(beta);
#pragma unroll
  for (int i = 0; i < L::TM; ++i) {
    const int m = m0 + ty + i * L::TY;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * L::TX;
      if (n >= N) continue;
      Acc v = al * acc[i][j];
      if (C != nullptr) v = v + be * C[(int64_t)m * c_sm + (int64_t)n * c_sn];
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
  typedef typename AccOf<T>::type Acc;
  constexpr size_t smem = smem_bytes<T, BM, BN, BK>();
  void (*kern)(const T*, int64_t, int64_t, const T*, int64_t, int64_t,
               const Acc*, int64_t, int64_t, T*, int64_t, int64_t,
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
      static_cast<const Acc*>(c), c_sm, c_sn, static_cast<T*>(o), o_sm, o_sn,
      M, N, K, alpha, beta);
  return cudaGetLastError();
}

}  // namespace

// Returns 0 on success, a cudaError_t code if the launch failed, and -1
// when (bm, bn, bk) is not an instance of the installed table.
extern "C" int IAAT_NAME(iaat_gemm)(int bm, int bn, int bk,
                                    const void* a, long long a_sm, long long a_sk,
                                    const void* b, long long b_sk, long long b_sn,
                                    const void* c, long long c_sm, long long c_sn,
                                    void* o, long long o_sm, long long o_sn,
                                    int M, int N, int K, double alpha,
                                    double beta, void* stream) {
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
