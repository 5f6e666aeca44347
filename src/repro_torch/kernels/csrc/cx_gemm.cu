// Complex IAAT GEMM region kernel for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel repro/kernels/iaat_gemm.py::_cx_body (called
// through _cx_call): C = alpha * op(A) @ op(B) + beta * C for one plan
// region, letters C (complex64) and Z (complex128), with complex alpha
// and beta.
//
// Arithmetic (as _cx_body, not a block-by-block copy of it): the 3-mult
// Karatsuba product.  Over the whole K loop each thread accumulates three
// planes in the plane type (f32 for C, f64 for Z),
//   P1 += Ar*Br,  P2 += Ai*Bi,  P3 += (Ar+Ai)*(Br+Bi),
// and combines them once after the loop: Cr = P1 - P2, Ci = P3 - P1 - P2.
// The epilogue is the complex alpha*acc + beta*C in the plane type; the
// output is the plane type, so there is no narrowing cast.  The sums
// Ar+Ai and Br+Bi are formed at FMA time from the staged planes, in the
// plane type, exactly as the plain version (templates.cmul_karatsuba)
// forms them before its third contraction: no shared memory for them and
// the same rounding.
//
// What bounds it on an H100: the paper's sizes (M = N = K <= 80) do a few
// MFLOP on a few hundred KB and are bound by the launch, not by the card;
// at 512^3 and beyond the 6MNK real operations at the f32 (C) or f64 (Z)
// peak bound it.  This kernel runs them as FMAs on CUDA cores, fed from
// shared memory: a simple kernel that is right first, no tensor cores
// (no wgmma for C, no DMMA for Z), no load pipelining.  Later PRs make it
// fast.
//
// No pack step.  The TPU kernel split A and B into real and imaginary
// planes with jnp.real / jnp.imag before the call (a copy); here every
// complex operand is read in place through its own strides, in complex
// elements: each (re, im) pair is one 8-byte (C) or 16-byte (Z) load, and
// consecutive threads walk the dim of unit complex stride (the real
// stride 2 of torch.view_as_real), so a warp's loads stay contiguous.
// The loader de-interleaves the pair into the real and imaginary tiles
// in shared memory; the store writes (re, im) pairs the same way into the
// strided complex output view that plan.execute hands over.
//
// Per CUDA block (256 threads, tile.cuh's Layout): one (BM x BN) output
// tile; per K step one (BK x BM) tile of op(A) and one (BK x BN) tile of
// op(B), each as a real and an imaginary plane, rows padded by one
// element; loads bounds-checked and zero-filled on M, N and K (the TPU
// kernel's iota K mask and clipped stores), so no scalar boundary path.
//
// Built by repro_torch/kernels/build.py: one object per letter
// (-DIAAT_LETTER=3 C, 4 Z), each including the generated list of
// (BM, BN, BK) instances of that letter, "iaat_table_<letter>.inc".

#include "tile.cuh"

namespace {

using namespace iaat;

template <typename T> struct Cx;
template <> struct Cx<float> { typedef float2 type; };
template <> struct Cx<double> { typedef double2 type; };

// Dynamic shared memory of one complex (BM, BN, BK) block: a real and an
// imaginary plane of each tile (vmem.footprint(..., complex_=True)).
template <typename T, int BM, int BN, int BK>
constexpr size_t cx_smem_bytes() {
  return 2 * smem_bytes<T, BM, BN, BK>();
}

// Stage re[k][j] + i im[k][j] = X[j0 + j, k0 + k] (zero outside J x K),
// X a complex matrix addressed through its strides (s_j, s_k) in complex
// elements.  Consecutive threads walk the dim of unit complex stride.
template <typename T, int W, int BK, int LD>
__device__ __forceinline__ void load_tile_cx(
    T* __restrict__ re, T* __restrict__ im,
    const typename Cx<T>::type* __restrict__ x, int64_t s_j, int64_t s_k,
    int j0, int J, int k0, int K) {
  typedef typename Cx<T>::type V;
  if (s_k == 1 && s_j != 1) {
    for (int e = threadIdx.x; e < W * BK; e += NT) {
      const int k = e % BK, j = e / BK;
      const int jg = j0 + j, kg = k0 + k;
      V v;
      v.x = T(0);
      v.y = T(0);
      if (jg < J && kg < K) v = x[(int64_t)jg * s_j + kg];
      re[k * LD + j] = v.x;
      im[k * LD + j] = v.y;
    }
  } else {
    for (int e = threadIdx.x; e < W * BK; e += NT) {
      const int j = e % W, k = e / W;
      const int jg = j0 + j, kg = k0 + k;
      V v;
      v.x = T(0);
      v.y = T(0);
      if (jg < J && kg < K) v = x[(int64_t)jg * s_j + (int64_t)kg * s_k];
      re[k * LD + j] = v.x;
      im[k * LD + j] = v.y;
    }
  }
}

template <typename T, int BM, int BN, int BK>
__global__ void __launch_bounds__(NT)
cx_gemm_kernel(const typename Cx<T>::type* __restrict__ A, int64_t a_sm,
               int64_t a_sk,
               const typename Cx<T>::type* __restrict__ B, int64_t b_sk,
               int64_t b_sn,
               const typename Cx<T>::type* __restrict__ C, int64_t c_sm,
               int64_t c_sn,
               typename Cx<T>::type* __restrict__ O, int64_t o_sm,
               int64_t o_sn, int M, int N, int K, double alpha_r,
               double alpha_i, double beta_r, double beta_i) {
  typedef Layout<BM, BN> L;
  typedef typename Cx<T>::type V;
  constexpr int PAD = pad_of<T>();
  constexpr int LDA = BM + PAD, LDB = BN + PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ar = reinterpret_cast<T*>(smem_raw);   // [BK][LDA]
  T* Ai = Ar + BK * LDA;                    // [BK][LDA]
  T* Br = Ai + BK * LDA;                    // [BK][LDB]
  T* Bi = Br + BK * LDB;                    // [BK][LDB]
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % L::TX, ty = threadIdx.x / L::TX;

  T p1[L::TM][TN], p2[L::TM][TN], p3[L::TM][TN];
#pragma unroll
  for (int i = 0; i < L::TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) p1[i][j] = p2[i][j] = p3[i][j] = T(0);

  for (int k0 = 0; k0 < K; k0 += BK) {
    load_tile_cx<T, BM, BK, LDA>(Ar, Ai, A, a_sm, a_sk, m0, M, k0, K);
    load_tile_cx<T, BN, BK, LDB>(Br, Bi, B, b_sn, b_sk, n0, N, k0, K);
    __syncthreads();
#pragma unroll 2
    for (int k = 0; k < BK; ++k) {
      T ar[L::TM], ai[L::TM], as[L::TM], br[TN], bi[TN], bs[TN];
#pragma unroll
      for (int i = 0; i < L::TM; ++i) {
        ar[i] = Ar[k * LDA + ty + i * L::TY];
        ai[i] = Ai[k * LDA + ty + i * L::TY];
        as[i] = ar[i] + ai[i];
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        br[j] = Br[k * LDB + tx + j * L::TX];
        bi[j] = Bi[k * LDB + tx + j * L::TX];
        bs[j] = br[j] + bi[j];
      }
#pragma unroll
      for (int i = 0; i < L::TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          p1[i][j] = fma(ar[i], br[j], p1[i][j]);
          p2[i][j] = fma(ai[i], bi[j], p2[i][j]);
          p3[i][j] = fma(as[i], bs[j], p3[i][j]);
        }
    }
    __syncthreads();
  }

  const T alr = T(alpha_r), ali = T(alpha_i);
  const T ber = T(beta_r), bei = T(beta_i);
#pragma unroll
  for (int i = 0; i < L::TM; ++i) {
    const int m = m0 + ty + i * L::TY;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * L::TX;
      if (n >= N) continue;
      // templates.karatsuba_combine, then _cx_body's complex epilogue
      const T cr = p1[i][j] - p2[i][j];
      const T ci = p3[i][j] - p1[i][j] - p2[i][j];
      T outr = alr * cr - ali * ci;
      T outi = alr * ci + ali * cr;
      if (C != nullptr) {
        const V co = C[(int64_t)m * c_sm + (int64_t)n * c_sn];
        outr += ber * co.x - bei * co.y;
        outi += ber * co.y + bei * co.x;
      }
      V o;
      o.x = outr;
      o.y = outi;
      O[(int64_t)m * o_sm + (int64_t)n * o_sn] = o;
    }
  }
}

template <typename T, int BM, int BN, int BK>
cudaError_t launch(const void* a, int64_t a_sm, int64_t a_sk,
                   const void* b, int64_t b_sk, int64_t b_sn,
                   const void* c, int64_t c_sm, int64_t c_sn,
                   void* o, int64_t o_sm, int64_t o_sn,
                   int M, int N, int K, double alpha_r, double alpha_i,
                   double beta_r, double beta_i, cudaStream_t stream) {
  typedef typename Cx<T>::type V;
  constexpr size_t smem = cx_smem_bytes<T, BM, BN, BK>();
  void (*kern)(const V*, int64_t, int64_t, const V*, int64_t, int64_t,
               const V*, int64_t, int64_t, V*, int64_t, int64_t, int, int,
               int, double, double, double, double) =
      cx_gemm_kernel<T, BM, BN, BK>;
  if (smem > 48 * 1024) {
    // opt in to dynamic shared memory above 48 KB, once per instance
    static const cudaError_t attr = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return attr;
  }
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const V*>(a), a_sm, a_sk, static_cast<const V*>(b), b_sk,
      b_sn, static_cast<const V*>(c), c_sm, c_sn, static_cast<V*>(o), o_sm,
      o_sn, M, N, K, alpha_r, alpha_i, beta_r, beta_i);
  return cudaGetLastError();
}

}  // namespace

// Strides are in complex elements (a complex tensor's own strides).
// Returns 0 on success, a cudaError_t code if the launch failed, and -1
// when (bm, bn, bk) is not an instance of the installed table.
extern "C" int IAAT_NAME(cx_gemm)(int bm, int bn, int bk,
                                  const void* a, long long a_sm, long long a_sk,
                                  const void* b, long long b_sk, long long b_sn,
                                  const void* c, long long c_sm, long long c_sn,
                                  void* o, long long o_sm, long long o_sn,
                                  int M, int N, int K, double alpha_r,
                                  double alpha_i, double beta_r,
                                  double beta_i, void* stream) {
#define IAAT_INSTANCE(BM, BN, BK)                                           \
  if (bm == BM && bn == BN && bk == BK)                                     \
    return (int)launch<Elem, BM, BN, BK>(a, a_sm, a_sk, b, b_sk, b_sn, c,   \
                                         c_sm, c_sn, o, o_sm, o_sn, M, N,   \
                                         K, alpha_r, alpha_i, beta_r,       \
                                         beta_i,                            \
                                         static_cast<cudaStream_t>(stream));
#include IAAT_TABLE
#undef IAAT_INSTANCE
  return -1;
}
