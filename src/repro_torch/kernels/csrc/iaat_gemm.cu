// IAAT GEMM region kernel for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel repro/kernels/iaat_gemm.py::_real_body (called
// through _real_call): C = alpha * op(A) @ op(B) + beta * C for one plan
// region, letters S (f32), D (f64) and H (bf16).
//
// What bounds it on an H100: on the main path (decode M=4 and prefill
// M=32 against 2048..50304-wide weights) the product does 4..32 flops per
// byte of B, far under the bf16 ridge of ~295, so it is bound by the
// bytes of B streamed from HBM, not by operations.  At M = 4 one olmo-1b
// decode step reads 2.3 GB of weights: 0.70 ms at 3.35 TB/s, if every SM
// keeps its loads in flight.  What the design does about that:
//   * split K (core/plan.py::k_slices): a region whose grid underfills
//     the 132 SMs (olmo's q/k/v/o and down projections tile into 8
//     blocks) is cut into K slices, grid (gn, gm, slices), so every SM
//     streams a share of the weights;
//   * each block sums its slice into an f32 (f64 for D) workspace of
//     (slices, M, N); the last block to finish an output tile, told by a
//     per-tile ticket (an atomicAdd after a __threadfence, reset to 0 by
//     that block, so the tickets stay zeroed between launches), sums the
//     slices in slice order (deterministic), applies the epilogue and
//     stores: one launch a region, no second reduce launch (tile.cuh
//     slice_span and split_reduce, shared with grouped_gemm.cu);
//   * the asynchronous path (tile.cuh ring_product) streams A and B
//     through a ring of up to 3 stages of 16-byte cp.async copies along
//     each operand's unit-stride dim, the NN weights along N and the tied
//     embed.T along K, so the next tiles' loads are in flight while the
//     block multiplies; fragment rows past M are not multiplied;
//   * operands whose unit-stride dim is not 16-byte aligned, or that have
//     none (odd strides, A read along M in TN/TT), take the scalar path
//     (tile.cuh block_product: synchronous, bounds-checked loads) in the
//     same kernel, chosen by the wrapper from the strides and counted
//     apart.
// The products stay f32 (f64 for D) FMAs on the CUDA cores: at M = 4 the
// step is bound by bytes, so tensor cores would buy nothing there.
//
// Design (per CUDA block, 256 threads):
//   * one block per (BM x BN) output tile and K slice; a loop over the
//     slice's K inside the block replaces the TPU's sequential K grid axis;
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
// (-DIAAT_LETTER=0 S, 1 D, 2 H) and path, each including the generated list of
// (BM, BN, BK) instances of that letter, "iaat_table_<letter>.inc", for
// one of the three paths (-DIAAT_MODE: 0 scalar, 1 ring with B read along
// N, 2 ring with B read along K); the nine objects build in parallel.

#include "tile.cuh"

namespace {

using namespace iaat;

template <typename T, int BM, int BN, int BK, int MODE>
__global__ void __launch_bounds__(NT)
iaat_gemm_kernel(const T* __restrict__ A, int64_t a_sm, int64_t a_sk,
                 const T* __restrict__ B, int64_t b_sk, int64_t b_sn,
                 const typename AccOf<T>::type* __restrict__ C, int64_t c_sm,
                 int64_t c_sn, T* __restrict__ O, int64_t o_sm, int64_t o_sn,
                 int M, int N, int K, double alpha, double beta,
                 typename AccOf<T>::type* __restrict__ ws,
                 unsigned int* __restrict__ tickets) {
  typedef typename AccOf<T>::type Acc;
  typedef Layout<BM, BN> L;
  constexpr bool B_KC = MODE == 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int slices = gridDim.z, z = blockIdx.z;
  int k_lo, k_hi;   // this block's K slice (plan.slice_steps)
  slice_span<BK>(K, slices, z, k_lo, k_hi);

  Acc acc[L::TM][TN];
  if constexpr (MODE == 0)
    block_product<T, BM, BN, BK>(acc, smem_raw, A + (int64_t)k_lo * a_sk,
                                 a_sm, a_sk, B + (int64_t)k_lo * b_sk, b_sk,
                                 b_sn, m0, M, n0, N, k_hi - k_lo);
  else
    ring_product<T, BM, BN, BK, B_KC>(acc, smem_raw, A, a_sm, B,
                                      B_KC ? b_sn : b_sk, m0, M, n0, N, k_lo,
                                      k_hi);

  const int tx = threadIdx.x % L::TX, ty = threadIdx.x / L::TX;
  auto col = [&](int j) {
    return MODE == 0 ? tx + j * L::TX : ring_col<BM, BN, B_KC>(tx, j);
  };
  // publish this slice's sums; the tile's last block reduces them
  if (slices > 1 &&
      !split_reduce(acc, ws, (int64_t)M * N, M, N,
                    tickets + blockIdx.y * gridDim.x + blockIdx.x, slices, z,
                    [&](int i) { return m0 + ty + i * L::TY; },
                    [&](int j) { return n0 + col(j); }))
    return;

  const Acc al = Acc(alpha), be = Acc(beta);
#pragma unroll
  for (int i = 0; i < L::TM; ++i) {
    const int m = m0 + ty + i * L::TY;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + col(j);
      if (n >= N) continue;
      Acc v = al * acc[i][j];
      if (C != nullptr) v = v + be * C[(int64_t)m * c_sm + (int64_t)n * c_sn];
      O[(int64_t)m * o_sm + (int64_t)n * o_sn] = narrow<T>(v);
    }
  }
}

template <typename T, int BM, int BN, int BK, int MODE>
cudaError_t launch(const void* a, int64_t a_sm, int64_t a_sk,
                   const void* b, int64_t b_sk, int64_t b_sn,
                   const void* c, int64_t c_sm, int64_t c_sn,
                   void* o, int64_t o_sm, int64_t o_sn,
                   int M, int N, int K, double alpha, double beta,
                   int slices, void* ws, void* tickets, cudaStream_t stream) {
  typedef typename AccOf<T>::type Acc;
  constexpr size_t smem = MODE == 0
                              ? smem_bytes<T, BM, BN, BK>()
                              : Ring<T, BM, BN, BK, MODE == 2>::SMEM_BYTES;
  void (*kern)(const T*, int64_t, int64_t, const T*, int64_t, int64_t,
               const Acc*, int64_t, int64_t, T*, int64_t, int64_t,
               int, int, int, double, double, Acc*, unsigned int*) =
      iaat_gemm_kernel<T, BM, BN, BK, MODE>;
  if (smem > 48 * 1024) {
    // opt in to dynamic shared memory above 48 KB, once per instance
    static const cudaError_t attr = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return attr;
  }
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, slices);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(a), a_sm, a_sk, static_cast<const T*>(b), b_sk, b_sn,
      static_cast<const Acc*>(c), c_sm, c_sn, static_cast<T*>(o), o_sm, o_sn,
      M, N, K, alpha, beta, static_cast<Acc*>(ws),
      static_cast<unsigned int*>(tickets));
  return cudaGetLastError();
}

}  // namespace

// One object per (letter, path): -DIAAT_MODE=0 the scalar path
// (iaat_gemm_scalar_<letter>), 1 the ring with B read along N (b_sn == 1;
// iaat_gemm_ring_n_<letter>), 2 the ring with B read along K (b_sk == 1;
// iaat_gemm_ring_k_<letter>); the ring paths need a_sk == 1 and
// 16-byte-aligned rows of A and B (the wrapper checks).  slices > 1 splits
// K: ws holds slices x M x N accumulators and tickets one zeroed counter
// per output tile of the grid.  Returns 0 on success, a cudaError_t code
// if the launch failed, and -1 when (bm, bn, bk) is not an instance of the
// installed table.
#if IAAT_MODE == 0
#define IAAT_ENTRY IAAT_NAME(iaat_gemm_scalar)
#elif IAAT_MODE == 1
#define IAAT_ENTRY IAAT_NAME(iaat_gemm_ring_n)
#elif IAAT_MODE == 2
#define IAAT_ENTRY IAAT_NAME(iaat_gemm_ring_k)
#else
#error "IAAT_MODE must be 0 (scalar), 1 (ring, B along N) or 2 (ring, B along K)"
#endif
extern "C" int IAAT_ENTRY(int bm, int bn, int bk,
                          const void* a, long long a_sm, long long a_sk,
                          const void* b, long long b_sk, long long b_sn,
                          const void* c, long long c_sm, long long c_sn,
                          void* o, long long o_sm, long long o_sn,
                          int M, int N, int K, double alpha, double beta,
                          int slices, void* ws, void* tickets, void* stream) {
#define IAAT_INSTANCE(BM, BN, BK)                                          \
  if (bm == BM && bn == BN && bk == BK)                                    \
    return (int)launch<Elem, BM, BN, BK, IAAT_MODE>(                       \
        a, a_sm, a_sk, b, b_sk, b_sn, c, c_sm, c_sn, o, o_sm, o_sn, M, N,  \
        K, alpha, beta, slices, ws, tickets,                               \
        static_cast<cudaStream_t>(stream));
#include IAAT_TABLE
#undef IAAT_INSTANCE
  return -1;
}

#if IAAT_LETTER == 0 && IAAT_MODE == 0
extern "C" const char* iaat_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
#endif
