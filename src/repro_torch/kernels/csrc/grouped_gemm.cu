// Grouped small-GEMM kernels for Hopper (sm_90a), plain C interface.
//
// Replace the TPU kernels of repro/kernels/grouped_gemm.py:
//   * batched_gemm (_batched_body): x (G, C, K) @ w (G, K, N) -> (G, C, N),
//     G independent equal-capacity products (the MoE expert FFN);
//   * ragged_gemm (_ragged_body): x (T, K) with rows group-contiguous in
//     row tiles of `tile` rows, @ w[gid[t]] (G, K, N) -> (T, N), one group
//     id per row tile (dropless MoE).
// Letters S (f32), D (f64) and H (bf16); f32 (f64 for D) accumulation and
// one cast to the operand type, as the TPU kernels' f32 scratch did.
//
// What bounds them on an H100: on the main path (moonshot-v1-16b-a3b
// decode, C = 8 rows per expert against (2048 x 1408) and (1408 x 2048)
// expert weights) a group does 2*C = 16 flops per weight element, 8 per
// byte of bf16, far under the bf16 ridge of ~295: the kernels are bound by
// the bytes of w streamed from HBM (all 64 experts' weights on every
// call, ~369 MB for gate or up).  What the design does about that: each
// weight element is read from global memory once per row block, and at
// C <= BM there is one row block per group, so once per call; blocks are
// wide in N (the table's widest bn that N fills) so the re-reads of the
// small x stay few.  It does not yet pipeline its loads (iaat_gemm.cu's
// cp.async ring, tile.cuh ring_product, is not used here) or use tensor
// cores: a simple kernel that is right comes first.
//
// Design (per CUDA block, 256 threads; tile.cuh's block_product):
//   * batched: grid (N/BN, C/BM, G); the block offsets x, w and the output
//     by its group blockIdx.z through their strides, then runs the
//     K loop; zero-filled loads replace the TPU kernel's K-tail iota mask
//     and rows >= C / columns >= N are neither read nor stored;
//   * ragged: grid (N/BN, T/tile * subs) with subs = ceil(tile / BM): block
//     y walks row tile t = y / subs, rows [t*tile + s*BM, ...) for
//     s = y % subs, and reads its own group id gid[t] from device memory
//     (the TPU kernel had it scalar-prefetched) to offset w.  A row tile
//     smaller than BM (tile 8 under the 16-row grain) is a block whose
//     rows past the tile are masked; a tile larger than BM spans several
//     blocks.  The wrapper checks every id is in [0, G) before the launch.
//
// Built by repro_torch/kernels/build.py beside iaat_gemm.cu: one object per
// letter (-DIAAT_LETTER=0 S, 1 D, 2 H) with the same instance list.

#include "tile.cuh"

namespace {

using namespace iaat;

template <typename T, int BM, int BN, int BK>
__global__ void __launch_bounds__(NT)
batched_gemm_kernel(const T* __restrict__ X, int64_t x_sg, int64_t x_sc,
                    int64_t x_sk, const T* __restrict__ W, int64_t w_sg,
                    int64_t w_sk, int64_t w_sn, T* __restrict__ O,
                    int64_t o_sg, int64_t o_sc, int64_t o_sn,
                    int C, int N, int K) {
  typedef typename AccOf<T>::type Acc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t g = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  Acc acc[Layout<BM, BN>::TM][TN];
  block_product<T, BM, BN, BK>(acc, smem_raw, X + g * x_sg, x_sc, x_sk,
                               W + g * w_sg, w_sk, w_sn, m0, C, n0, N, K);
  store_block<T, BM, BN>(acc, O + g * o_sg, o_sc, o_sn, m0, C, n0, N);
}

template <typename T, int BM, int BN, int BK>
__global__ void __launch_bounds__(NT)
ragged_gemm_kernel(const T* __restrict__ X, int64_t x_st, int64_t x_sk,
                   const T* __restrict__ W, int64_t w_sg, int64_t w_sk,
                   int64_t w_sn, const int* __restrict__ gids, int tile,
                   int subs, T* __restrict__ O, int64_t o_st, int64_t o_sn,
                   int N, int K) {
  typedef typename AccOf<T>::type Acc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int t = blockIdx.y / subs, s = blockIdx.y % subs;
  const int64_t r0 = (int64_t)t * tile + (int64_t)s * BM;
  const int rows = min(BM, tile - s * BM);
  const int64_t g = gids[t];
  const int n0 = blockIdx.x * BN;
  Acc acc[Layout<BM, BN>::TM][TN];
  block_product<T, BM, BN, BK>(acc, smem_raw, X + r0 * x_st, x_st, x_sk,
                               W + g * w_sg, w_sk, w_sn, 0, rows, n0, N, K);
  store_block<T, BM, BN>(acc, O + r0 * o_st, o_st, o_sn, 0, rows, n0, N);
}

template <typename T, int BM, int BN, int BK>
cudaError_t launch_batched(const void* x, int64_t x_sg, int64_t x_sc,
                           int64_t x_sk, const void* w, int64_t w_sg,
                           int64_t w_sk, int64_t w_sn, void* o, int64_t o_sg,
                           int64_t o_sc, int64_t o_sn, int G, int C, int N,
                           int K, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, BM, BN, BK>();
  void (*kern)(const T*, int64_t, int64_t, int64_t, const T*, int64_t,
               int64_t, int64_t, T*, int64_t, int64_t, int64_t, int, int,
               int) = batched_gemm_kernel<T, BM, BN, BK>;
  if (smem > 48 * 1024) {
    // opt in to dynamic shared memory above 48 KB, once per instance
    static const cudaError_t attr = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return attr;
  }
  dim3 grid((N + BN - 1) / BN, (C + BM - 1) / BM, G);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), x_sg, x_sc, x_sk, static_cast<const T*>(w),
      w_sg, w_sk, w_sn, static_cast<T*>(o), o_sg, o_sc, o_sn, C, N, K);
  return cudaGetLastError();
}

template <typename T, int BM, int BN, int BK>
cudaError_t launch_ragged(const void* x, int64_t x_st, int64_t x_sk,
                          const void* w, int64_t w_sg, int64_t w_sk,
                          int64_t w_sn, const void* gids, int tile,
                          int ntiles, void* o, int64_t o_st, int64_t o_sn,
                          int N, int K, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, BM, BN, BK>();
  void (*kern)(const T*, int64_t, int64_t, const T*, int64_t, int64_t,
               int64_t, const int*, int, int, T*, int64_t, int64_t, int,
               int) = ragged_gemm_kernel<T, BM, BN, BK>;
  if (smem > 48 * 1024) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return attr;
  }
  const int subs = (tile + BM - 1) / BM;
  dim3 grid((N + BN - 1) / BN, ntiles * subs);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), x_st, x_sk, static_cast<const T*>(w), w_sg,
      w_sk, w_sn, static_cast<const int*>(gids), tile, subs,
      static_cast<T*>(o), o_st, o_sn, N, K);
  return cudaGetLastError();
}

}  // namespace

// Both entries return 0 on success, a cudaError_t code if the launch
// failed, and -1 when (bm, bn, bk) is not an instance of the installed
// table.  Sizes are checked by the Python wrapper (kernels/grouped_gemm.py).
extern "C" int IAAT_NAME(batched_gemm)(int bm, int bn, int bk,
                                       const void* x, long long x_sg,
                                       long long x_sc, long long x_sk,
                                       const void* w, long long w_sg,
                                       long long w_sk, long long w_sn,
                                       void* o, long long o_sg,
                                       long long o_sc, long long o_sn,
                                       int G, int C, int N, int K,
                                       void* stream) {
#define IAAT_INSTANCE(BM, BN, BK)                                           \
  if (bm == BM && bn == BN && bk == BK)                                     \
    return (int)launch_batched<Elem, BM, BN, BK>(                           \
        x, x_sg, x_sc, x_sk, w, w_sg, w_sk, w_sn, o, o_sg, o_sc, o_sn, G,   \
        C, N, K, static_cast<cudaStream_t>(stream));
#include IAAT_TABLE
#undef IAAT_INSTANCE
  return -1;
}

extern "C" int IAAT_NAME(ragged_gemm)(int bm, int bn, int bk,
                                      const void* x, long long x_st,
                                      long long x_sk, const void* w,
                                      long long w_sg, long long w_sk,
                                      long long w_sn, const void* gids,
                                      int tile, int ntiles, void* o,
                                      long long o_st, long long o_sn,
                                      int N, int K, void* stream) {
#define IAAT_INSTANCE(BM, BN, BK)                                           \
  if (bm == BM && bn == BN && bk == BK)                                     \
    return (int)launch_ragged<Elem, BM, BN, BK>(                            \
        x, x_st, x_sk, w, w_sg, w_sk, w_sn, gids, tile, ntiles, o, o_st,    \
        o_sn, N, K, static_cast<cudaStream_t>(stream));
#include IAAT_TABLE
#undef IAAT_INSTANCE
  return -1;
}
