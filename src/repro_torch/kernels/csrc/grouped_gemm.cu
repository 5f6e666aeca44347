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
// Both run one kernel, grouped_gemm_kernel: batched is the ragged form
// with tile = C and the group id equal to the tile's index.
//
// What bounds them on an H100: on the main path (moonshot-v1-16b-a3b
// decode, C = 8 rows per expert against (2048 x 1408) and (1408 x 2048)
// expert weights) a group does 2*C = 16 flops per weight element, 8 per
// byte of bf16, far under the bf16 ridge of ~295: the kernels are bound by
// the bytes of w streamed from HBM (all 64 experts' weights on every
// batched call, ~369 MB for gate or up: 0.110 ms at 3.35 TB/s).  What the
// design does about that:
//   * each weight element is read from global memory once per row block,
//     and at C <= BM there is one row block per group, so once per call;
//   * the ring path (tile.cuh) streams x and w through a cp.async ring of
//     up to 3 stages of 16-byte copies (sized for w read along N alone,
//     so (16, 256, 64) bf16 takes 3 stages within two blocks an SM), so
//     the next tiles' loads are in flight while the block multiplies; it
//     needs x's k and w's n of unit
//     stride and 16-byte-aligned rows (the MoE layer's buffers and
//     weights), chosen by the wrapper from the strides; other operands
//     take the scalar path (tile.cuh block_product: synchronous,
//     bounds-checked loads) in the same source;
//   * a grid of fewer blocks than fill the memory (a block streams its
//     weights at a rate its copies in flight set, so about one block an
//     SM fills it: plan.grouped_slices; one token's ragged decode step,
//     6 tiles of 6 or 8 column blocks) is cut along K into slices,
//     summed in one launch by tile.cuh's split_reduce (ordered,
//     ticketed; the IAAT kernel's own fix-up), so more SMs stream a
//     share of the weights;
//   * for bf16 the ring's tiles go to the tensor cores (tile.cuh
//     ring_mma_product: mma.sync m16n8k16, f32 sums) as out^T = w^T x^T:
//     the weights' N on the mma's 16-row side and a group's 8 rows on its
//     8-column side, so the CUDA cores neither widen nor multiply and no
//     lane is spent on padding rows.  S stays f32 FMAs (never TF32) and D
//     f64 FMAs, on the CUDA cores (tile.cuh ring_product).
//
// Design (per CUDA block, 256 threads): grid (N/BN x slices, ceil(tile /
// BM), tiles); block (x, y, z) takes column block x / slices, K slice
// x % slices, rows [y BM, y BM + BM) of row tile z (batched: of group z),
// and offsets x, w and the output through their strides: the group
// (batched: z; ragged: its own gids[z] read, which the TPU kernel had
// scalar-prefetched) times w's group stride.  Rows past the tile (a
// ragged tile of 8 under the 16-row grain, a group of C < BM), columns
// past N and the K tail are zero-filled on load and not stored, which
// replaces the TPU kernel's iota K mask.  A ragged tile whose id is -1
// is idle: its blocks exit before they load anything, so a table sized
// for the worst case (the dropless MoE layer's) streams only the live
// tiles' weights.  Unless the caller allows idle tiles, the wrapper
// checks every id is in [0, G) before the launch.
//
// Built by repro_torch/kernels/build.py beside iaat_gemm.cu: one object per
// letter (-DIAAT_LETTER=0 S, 1 D, 2 H) and path (-DIAAT_MODE=0 scalar,
// 1 ring) with the same instance list.

#include <type_traits>

#include "tile.cuh"

namespace {

using namespace iaat;

// Split K if sliced, then store acc[i][j] at the block-relative row
// row(i) < rows and the column col(j) < N.
template <typename T, typename Acc, int I, int J, typename Row, typename Col>
__device__ __forceinline__ void finish(Acc (&acc)[I][J], Row row, Col col,
                                       int rows, int N, T* __restrict__ O,
                                       int64_t o_sr, int64_t o_sn, Acc* ws,
                                       int64_t step, unsigned int* ticket,
                                       int slices, int z) {
  if (slices > 1 &&
      !split_reduce(acc, ws, step, rows, N, ticket, slices, z, row, col))
    return;
#pragma unroll
  for (int i = 0; i < I; ++i) {
    const int m = row(i);
    if (m >= rows) continue;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int n = col(j);
      if (n < N)
        O[(int64_t)m * o_sr + (int64_t)n * o_sn] = narrow<T>(acc[i][j]);
    }
  }
}

// x rows of tile t at X + t x_st + r x_sr + k x_sk; w of group g at
// W + g w_sg + k w_sk + n w_sn; the output likewise through (o_st, o_sr,
// o_sn).  gids null: group t (batched).  ws: slices x (tiles x tile) x N
// accumulators and tickets one zeroed counter per output tile, used only
// when slices > 1.  MODE 0 the scalar path, 1 the ring (x_sk == w_sn ==
// 1, rows 16-byte aligned).
template <typename T, int BM, int BN, int BK, int MODE>
__global__ void __launch_bounds__(NT)
grouped_gemm_kernel(const T* __restrict__ X, int64_t x_st, int64_t x_sr,
                    int64_t x_sk, const T* __restrict__ W, int64_t w_sg,
                    int64_t w_sk, int64_t w_sn, const int* __restrict__ gids,
                    int tile, T* __restrict__ O, int64_t o_st, int64_t o_sr,
                    int64_t o_sn, int N, int K,
                    typename AccOf<T>::type* __restrict__ ws,
                    unsigned int* __restrict__ tickets) {
  typedef typename AccOf<T>::type Acc;
  constexpr bool MMA = MODE == 1 && std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int gn = (N + BN - 1) / BN;
  const int slices = gridDim.x / gn;
  const int nb = blockIdx.x / slices, z = blockIdx.x % slices;
  const int t = blockIdx.z, r0 = blockIdx.y * BM;
  const int rows = min(BM, tile - r0);
  const int64_t g = gids != nullptr ? gids[t] : t;
  // an idle ragged tile (id -1: past the live tiles of a table sized for
  // the worst case) loads, multiplies and stores nothing; every block of
  // it leaves here, so its split ticket is never taken
  if (g < 0) return;
  const T* Xb = X + t * x_st + r0 * x_sr;
  const T* Wb = W + g * w_sg;
  T* Ob = O + t * o_st + r0 * o_sr;
  const int n0 = nb * BN;
  int k_lo, k_hi;   // this block's K slice (plan.slice_steps)
  slice_span<BK>(K, slices, z, k_lo, k_hi);
  // the block's rows of every slice of the workspace, and its tile's
  // ticket
  Acc* wsb = slices > 1 ? ws + ((int64_t)t * tile + r0) * N : ws;
  const int64_t step = (int64_t)gridDim.z * tile * N;
  unsigned int* ticket =
      slices > 1 ? tickets + ((int64_t)t * gridDim.y + blockIdx.y) * gn + nb
                 : tickets;

  if constexpr (MMA) {
    typedef MmaLayout<BM, BN> WL;
    float acc[WL::ROWS][WL::COLS];
    ring_mma_product<BM, BN, BK>(acc, smem_raw, Xb, x_sr, Wb, w_sk, rows,
                                 n0, N, k_lo, k_hi);
    finish<T>(acc, [](int i) { return mma_row<BM, BN>(i); },
              [&](int j) { return n0 + mma_col<BM, BN>(j); }, rows, N, Ob,
              o_sr, o_sn, wsb, step, ticket, slices, z);
  } else {
    typedef Layout<BM, BN> L;
    Acc acc[L::TM][TN];
    if constexpr (MODE == 0)
      block_product<T, BM, BN, BK>(acc, smem_raw, Xb + (int64_t)k_lo * x_sk,
                                   x_sr, x_sk, Wb + (int64_t)k_lo * w_sk,
                                   w_sk, w_sn, 0, rows, n0, N, k_hi - k_lo);
    else
      ring_product<T, BM, BN, BK, false, true>(acc, smem_raw, Xb, x_sr, Wb,
                                               w_sk, 0, rows, n0, N, k_lo,
                                               k_hi);
    const int tx = threadIdx.x % L::TX, ty = threadIdx.x / L::TX;
    finish<T>(acc, [&](int i) { return ty + i * L::TY; },
              [&](int j) {
                return n0 + (MODE == 0 ? tx + j * L::TX
                                       : ring_col<BM, BN, false>(tx, j));
              },
              rows, N, Ob, o_sr, o_sn, wsb, step, ticket, slices, z);
  }
}

template <typename T, int BM, int BN, int BK, int MODE>
cudaError_t launch(const void* x, int64_t x_st, int64_t x_sr, int64_t x_sk,
                   const void* w, int64_t w_sg, int64_t w_sk, int64_t w_sn,
                   const void* gids, int tile, int ntiles, void* o,
                   int64_t o_st, int64_t o_sr, int64_t o_sn, int N, int K,
                   int slices, void* ws, void* tickets, cudaStream_t stream) {
  typedef typename AccOf<T>::type Acc;
  constexpr size_t smem = MODE == 0
                              ? smem_bytes<T, BM, BN, BK>()
                              : Ring<T, BM, BN, BK, false, true>::SMEM_BYTES;
  auto kern = grouped_gemm_kernel<T, BM, BN, BK, MODE>;
  if (smem > 48 * 1024) {
    // opt in to dynamic shared memory above 48 KB, once per instance
    static const cudaError_t attr = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return attr;
  }
  dim3 grid((N + BN - 1) / BN * slices, (tile + BM - 1) / BM, ntiles);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), x_st, x_sr, x_sk, static_cast<const T*>(w),
      w_sg, w_sk, w_sn, static_cast<const int*>(gids), tile,
      static_cast<T*>(o), o_st, o_sr, o_sn, N, K, static_cast<Acc*>(ws),
      static_cast<unsigned int*>(tickets));
  return cudaGetLastError();
}

}  // namespace

// One object per (letter, path): -DIAAT_MODE=0 exports
// batched_gemm_scalar_<letter> and ragged_gemm_scalar_<letter>, 1 the
// ring's batched_gemm_ring_<letter> and ragged_gemm_ring_<letter>.  Both
// entries return 0 on success, a cudaError_t code if the launch failed,
// and -1 when (bm, bn, bk) is not an instance of the installed table.
// Sizes, strides, slices and the workspace are checked by the Python
// wrapper (kernels/grouped_gemm.py).
#if IAAT_MODE == 0
#define GROUPED_NAME(base) IAAT_NAME(base##_scalar)
#elif IAAT_MODE == 1
#define GROUPED_NAME(base) IAAT_NAME(base##_ring)
#else
#error "IAAT_MODE must be 0 (scalar) or 1 (ring)"
#endif

extern "C" int GROUPED_NAME(batched_gemm)(
    int bm, int bn, int bk, const void* x, long long x_sg, long long x_sc,
    long long x_sk, const void* w, long long w_sg, long long w_sk,
    long long w_sn, void* o, long long o_sg, long long o_sc, long long o_sn,
    int G, int C, int N, int K, int slices, void* ws, void* tickets,
    void* stream) {
#define IAAT_INSTANCE(BM, BN, BK)                                           \
  if (bm == BM && bn == BN && bk == BK)                                     \
    return (int)launch<Elem, BM, BN, BK, IAAT_MODE>(                        \
        x, x_sg, x_sc, x_sk, w, w_sg, w_sk, w_sn, nullptr, C, G, o, o_sg,   \
        o_sc, o_sn, N, K, slices, ws, tickets,                              \
        static_cast<cudaStream_t>(stream));
#include IAAT_TABLE
#undef IAAT_INSTANCE
  return -1;
}

extern "C" int GROUPED_NAME(ragged_gemm)(
    int bm, int bn, int bk, const void* x, long long x_st, long long x_sk,
    const void* w, long long w_sg, long long w_sk, long long w_sn,
    const void* gids, int tile, int ntiles, void* o, long long o_st,
    long long o_sn, int N, int K, int slices, void* ws, void* tickets,
    void* stream) {
#define IAAT_INSTANCE(BM, BN, BK)                                           \
  if (bm == BM && bn == BN && bk == BK)                                     \
    return (int)launch<Elem, BM, BN, BK, IAAT_MODE>(                        \
        x, tile * x_st, x_st, x_sk, w, w_sg, w_sk, w_sn, gids, tile,        \
        ntiles, o, tile * o_st, o_st, o_sn, N, K, slices, ws, tickets,      \
        static_cast<cudaStream_t>(stream));
#include IAAT_TABLE
#undef IAAT_INSTANCE
  return -1;
}
