// Complex IAAT GEMM for Hopper (sm_90a), plain C interface: one launch
// runs every region of a complex plan.
//
// Replaces the TPU kernel repro/kernels/iaat_gemm.py::_cx_body (called
// through _cx_call): C = alpha * op(A) @ op(B) + beta * C, letters C
// (complex64) and Z (complex128), with complex alpha and beta.
//
// Arithmetic (as _cx_body, not a block-by-block copy of it): the 3-mult
// Karatsuba product.  Over the whole K loop each output accumulates three
// planes in the plane type (f32 for C, f64 for Z),
//   P1 += Ar*Br,  P2 += Ai*Bi,  P3 += (Ar+Ai)*(Br+Bi),
// combined once after the loop: Cr = P1 - P2, Ci = P3 - P1 - P2.  The
// epilogue is the complex alpha*acc + beta*C in the plane type.  The sums
// Ar+Ai and Br+Bi are formed in the plane type from the staged (re, im)
// pairs, as the plain version (templates.cmul_karatsuba) forms them
// before its third contraction: the same rounding.
//
// One launch a plan.  The wrapper (kernels/iaat_gemm.py) hands over the
// plan's region table (core/plan.py::Plan.launch_tables): per region its
// first block, its rows [m0, m_hi) and columns [n0, n_hi) clipped to the
// output, its blocks across, and the (BM, BN, BK) instance the install-time
// table generated for it.  The grid is the blocks of every region; a
// block finds its region (the last whose first block is at or before its
// own) and runs that region's tile shape as a device function.  So each
// region is still served by the kernel generated for its block size, with
// no pack and no scalar boundary code: only the launch is shared.  At the
// paper's sizes (M = N = K <= 80, two regions) the call is bound by host
// time and launches, so one launch and one pass over the arguments is
// what buys time there.
//
// What bounds it on an H100 past those sizes: the 6MNK real operations.
//   * Z runs on the f64 tensor cores: mma.sync m16n8k8 .f64 (DMMA), whose
//     products and sums are IEEE f64 FMAs.  The 8 warps of a block split
//     it into strips (ZLayout: two n8 tiles a warp where the block is
//     wide enough, so each A fragment read from shared memory feeds two
//     mmas); each warp keeps three planes of its m16n8 accumulator tiles.
//     A thread forms the Karatsuba sums of its fragment elements as it
//     reads them, once per fragment.
//   * C stays on f32 FMAs on the CUDA cores (no TF32 in any form): each
//     thread owns TM x 4 outputs of the block (two pairs of adjacent
//     columns BN/2 apart, pairs of adjacent rows BM/2 apart), reads each
//     two (re, im) pairs as one 16-byte shared load, and does 12 TM FMAs
//     and TM + 4 adds a k step for TM/2 + 2 loads.
//   * Both stream the operands through a cp.async ring: each K step of
//     BK is cut into BK/16 stages of 16 k rows, so the copies of the next
//     stages are in flight while the block multiplies the current one,
//     in the shared memory of one BK step.
//
// No pack step.  Every complex operand is read in place through its own
// strides, in complex elements: each (re, im) pair is one 8-byte (C) or
// 16-byte (Z) cp.async, so any layout (the four transpositions, sliced
// views, .T views) takes the same path; consecutive threads walk the dim
// of unit stride.  Tiles are staged k-major, [k][j] with j contiguous and
// rows padded by two complex elements, so that the 16-byte fragment
// reads of a quarter warp fall on eight distinct 16-byte bank groups.
// Loads past a region's rows or columns, or past K, are zero-filled
// through cp.async's source size; the store is clipped to the region.
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

constexpr int CX_PAD = 2;          // complex elements padding a staged row
constexpr int KS = 16;             // k rows of one ring stage
constexpr int MAX_REGIONS = 64;    // core/plan.py LAUNCH_REGIONS

// One region of a launch (core/plan.py::Plan.launch_tables).
struct Region {
  int start, m0, m_hi, n0, n_hi, gn, bm, bn, bk;
};
struct Table {
  int n;
  Region r[MAX_REGIONS];
};

// The ring of a (BM, BN, BK) block: BK/KS stages, each KS rows of the
// op(A) tile (BM complex) and of the op(B) tile (BN complex).
template <typename T, int BM, int BN, int BK>
struct CxRing {
  typedef typename Cx<T>::type V;
  static constexpr int LDA = BM + CX_PAD, LDB = BN + CX_PAD;
  static constexpr int STAGE = KS * (LDA + LDB);   // complex elements
  static constexpr int STAGES = BK / KS;
  static constexpr size_t SMEM = (size_t)STAGES * STAGE * sizeof(V);
  static_assert(BK % KS == 0 && STAGES >= 2, "two stages at least");
  static_assert(SMEM <= 232448, "the ring must fit 227 KB");
};

template <int BYTES>
__device__ __forceinline__ void cp_async_cx(void* dst, const void* src,
                                            int n) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
}

// Stage tile[k][j] = X[j0 + j, k0 + k] for k < KS, j < W, zero where
// j0 + j >= J or k0 + k >= K; X addressed through its strides (s_j, s_k)
// in complex elements.  Consecutive threads walk the dim of unit stride.
template <typename V, int W, int LD>
__device__ __forceinline__ void stage_cx(V* tile, const V* __restrict__ x,
                                         int64_t s_j, int64_t s_k, int j0,
                                         int J, int k0, int K) {
  const bool k_unit = s_k == 1 && s_j != 1;
  for (int e = threadIdx.x; e < W * KS; e += NT) {
    const int k = k_unit ? e % KS : e / W, j = k_unit ? e / KS : e % W;
    const int jg = j0 + j, kg = k0 + k;
    const bool in = jg < J && kg < K;
    cp_async_cx<sizeof(V)>(tile + k * LD + j,
                           in ? x + (int64_t)jg * s_j + (int64_t)kg * s_k : x,
                           in ? (int)sizeof(V) : 0);
  }
}

// out[m, n] = alpha * (cr + i ci) + beta * C[m, n], for m < m_hi, n < n_hi
template <typename T>
__device__ __forceinline__ void store_cx(
    typename Cx<T>::type* __restrict__ O, int64_t o_sm, int64_t o_sn,
    const typename Cx<T>::type* __restrict__ C, int64_t c_sm, int64_t c_sn,
    int m, int n, T p1, T p2, T p3, T alr, T ali, T ber, T bei) {
  typedef typename Cx<T>::type V;
  // templates.karatsuba_combine, then _cx_body's complex epilogue
  const T cr = p1 - p2;
  const T ci = p3 - p1 - p2;
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

struct Args {
  const void* A;
  int64_t a_sm, a_sk;
  const void* B;
  int64_t b_sk, b_sn;
  const void* C;
  int64_t c_sm, c_sn;
  void* O;
  int64_t o_sm, o_sn;
  int K;
  double alpha_r, alpha_i, beta_r, beta_i;
};

// The K loop of one block through the ring; compute(As, Bs) multiplies
// one stage (KS rows of each tile).
template <typename T, int BM, int BN, int BK, typename F>
__device__ __forceinline__ void ring_loop(unsigned char* smem_raw,
                                          const Args& g, int m0, int m_hi,
                                          int n0, int n_hi, F compute) {
  typedef CxRing<T, BM, BN, BK> R;
  typedef typename Cx<T>::type V;
  constexpr int S = R::STAGES;
  V* base = reinterpret_cast<V*>(smem_raw);
  const V* A = static_cast<const V*>(g.A);
  const V* B = static_cast<const V*>(g.B);
  const int steps = (g.K + KS - 1) / KS;
  auto issue = [&](int step) {
    if (step < steps) {
      V* As = base + (step % S) * R::STAGE;
      V* Bs = As + KS * R::LDA;
      const int k0 = step * KS;
      stage_cx<V, BM, R::LDA>(As, A, g.a_sm, g.a_sk, m0, m_hi, k0, g.K);
      stage_cx<V, BN, R::LDB>(Bs, B, g.b_sn, g.b_sk, n0, n_hi, k0, g.K);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) issue(s);
  for (int step = 0; step < steps; ++step) {
    issue(step + S - 1);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(S - 1) : "memory");
    __syncthreads();
    const V* As = base + (step % S) * R::STAGE;
    compute(As, As + KS * R::LDA);
    __syncthreads();   // the stage is free for the copies of step + S
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// C: f32 FMAs on the CUDA cores.
// ---------------------------------------------------------------------------

// Thread (tx, ty) of Layout<BM, BN>: row i of its TM rows and column j of
// its 4 columns, block-relative.  Pairs of adjacent rows (columns) are
// BM/2 (BN/2) apart, so a quarter warp's 16-byte reads cover 128
// contiguous bytes.
template <int BM, int BN>
__device__ __forceinline__ int c_row(int ty, int i) {
  return Layout<BM, BN>::TM == 1 ? ty : (i >> 1) * (BM / 2) + 2 * ty + (i & 1);
}
template <int BM, int BN>
__device__ __forceinline__ int c_col(int tx, int j) {
  return (j >> 1) * (BN / 2) + 2 * tx + (j & 1);
}

template <int BM, int BN, int BK>
__device__ __forceinline__ void tile_c(unsigned char* smem_raw,
                                       const Args& g, int m0, int m_hi,
                                       int n0, int n_hi) {
  typedef Layout<BM, BN> L;
  typedef CxRing<float, BM, BN, BK> R;
  constexpr int TM = L::TM;
  static_assert(TM == 1 || TM == 2 || TM == 4, "rows a thread");
  static_assert(L::TX * 4 == BN && L::TY * TM == BM, "thread layout");
  const int tx = threadIdx.x % L::TX, ty = threadIdx.x / L::TX;
  float p1[TM][TN], p2[TM][TN], p3[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) p1[i][j] = p2[i][j] = p3[i][j] = 0.f;

  ring_loop<float, BM, BN, BK>(
      smem_raw, g, m0, m_hi, n0, n_hi,
      [&](const float2* As, const float2* Bs) {
#pragma unroll
        for (int k = 0; k < KS; ++k) {
          float ar[TM], ai[TM], as[TM], br[TN], bi[TN], bs[TN];
          if constexpr (TM == 1) {
            const float2 v = As[k * R::LDA + ty];
            ar[0] = v.x;
            ai[0] = v.y;
          } else {
#pragma unroll
            for (int h = 0; h < TM / 2; ++h) {
              const float4 v = *reinterpret_cast<const float4*>(
                  As + k * R::LDA + h * (BM / 2) + 2 * ty);
              ar[2 * h] = v.x;
              ai[2 * h] = v.y;
              ar[2 * h + 1] = v.z;
              ai[2 * h + 1] = v.w;
            }
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float4 v = *reinterpret_cast<const float4*>(
                Bs + k * R::LDB + h * (BN / 2) + 2 * tx);
            br[2 * h] = v.x;
            bi[2 * h] = v.y;
            br[2 * h + 1] = v.z;
            bi[2 * h + 1] = v.w;
          }
#pragma unroll
          for (int i = 0; i < TM; ++i) as[i] = ar[i] + ai[i];
#pragma unroll
          for (int j = 0; j < TN; ++j) bs[j] = br[j] + bi[j];
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) {
              p1[i][j] = fmaf(ar[i], br[j], p1[i][j]);
              p2[i][j] = fmaf(ai[i], bi[j], p2[i][j]);
              p3[i][j] = fmaf(as[i], bs[j], p3[i][j]);
            }
        }
      });

  const float alr = float(g.alpha_r), ali = float(g.alpha_i);
  const float ber = float(g.beta_r), bei = float(g.beta_i);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + c_row<BM, BN>(ty, i);
    if (m >= m_hi) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + c_col<BM, BN>(tx, j);
      if (n < n_hi)
        store_cx<float>(static_cast<float2*>(g.O), g.o_sm, g.o_sn,
                        static_cast<const float2*>(g.C), g.c_sm, g.c_sn, m,
                        n, p1[i][j], p2[i][j], p3[i][j], alr, ali, ber, bei);
    }
  }
}

// ---------------------------------------------------------------------------
// Z: f64 tensor cores, mma.sync m16n8k8 .f64.
//
// Fragments (PTX ISA, mma.m16n8k8 .f64; gid = lane / 4, tig = lane % 4):
//   A (16 x 8, row):  a[q] = A[gid + 8 (q & 1)][tig + 4 (q >> 1)], q < 4
//   B (8 x 8, col):   b[q] = B[tig + 4 q][gid], q < 2
//   D (16 x 8):       d[q] = D[gid + 8 (q >> 1)][2 tig + (q & 1)], q < 4
// ---------------------------------------------------------------------------

__device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[4],
                                     const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// The 8 warps as WM row strips x WN column strips: as many column strips
// as leave each warp two n8 tiles (so each A fragment feeds two mmas),
// within the block's m16 tiles.
template <int BM, int BN>
struct ZLayout {
  static constexpr int WARPS = NT / 32;
  static constexpr int WN_MIN = WARPS / (BM / 16);
  static constexpr int WN_TWO = BN / 16 < WARPS ? BN / 16 : WARPS;
  static constexpr int WN = WN_TWO > WN_MIN ? WN_TWO : WN_MIN;
  static constexpr int WM = WARPS / WN;
  static constexpr int MT = BM / (16 * WM);       // m16 tiles of a warp
  static constexpr int NF = BN / (8 * WN);        // n8 tiles of a warp
  static_assert(WM * WN == WARPS && MT * 16 * WM == BM &&
                    NF * 8 * WN == BN && MT >= 1 && NF >= 1,
                "Z warp layout");
};

template <int BM, int BN, int BK>
__device__ __forceinline__ void tile_z(unsigned char* smem_raw,
                                       const Args& g, int m0, int m_hi,
                                       int n0, int n_hi) {
  typedef ZLayout<BM, BN> W;
  typedef CxRing<double, BM, BN, BK> R;
  constexpr int MT = W::MT, NF = W::NF;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int col0 = (warp % W::WN) * NF * 8;    // the warp's column strip
  const int row0 = (warp / W::WN) * MT * 16;   // and its row strip
  double p1[MT][NF][4], p2[MT][NF][4], p3[MT][NF][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nf = 0; nf < NF; ++nf)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        p1[mt][nf][q] = p2[mt][nf][q] = p3[mt][nf][q] = 0.0;

  ring_loop<double, BM, BN, BK>(
      smem_raw, g, m0, m_hi, n0, n_hi,
      [&](const double2* As, const double2* Bs) {
#pragma unroll
        for (int kk = 0; kk < KS; kk += 8) {
          // one m16 tile of A at a time, then one n8 tile of B at a time:
          // three planes of each, the sums formed once as read
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            double ar[4], ai[4], as[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const double2 v = As[(kk + tig + 4 * (q >> 1)) * R::LDA +
                                   row0 + mt * 16 + gid + 8 * (q & 1)];
              ar[q] = v.x;
              ai[q] = v.y;
              as[q] = v.x + v.y;
            }
#pragma unroll
            for (int nf = 0; nf < NF; ++nf) {
              double br[2], bi[2], bs[2];
#pragma unroll
              for (int q = 0; q < 2; ++q) {
                const double2 v =
                    Bs[(kk + tig + 4 * q) * R::LDB + col0 + nf * 8 + gid];
                br[q] = v.x;
                bi[q] = v.y;
                bs[q] = v.x + v.y;
              }
              dmma(p1[mt][nf], ar, br);
              dmma(p2[mt][nf], ai, bi);
              dmma(p3[mt][nf], as, bs);
            }
          }
        }
      });

  const double alr = g.alpha_r, ali = g.alpha_i;
  const double ber = g.beta_r, bei = g.beta_i;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int m = m0 + row0 + mt * 16 + gid + 8 * (q >> 1);
      if (m >= m_hi) continue;
#pragma unroll
      for (int nf = 0; nf < NF; ++nf) {
        const int n = n0 + col0 + nf * 8 + 2 * tig + (q & 1);
        if (n < n_hi)
          store_cx<double>(static_cast<double2*>(g.O), g.o_sm, g.o_sn,
                           static_cast<const double2*>(g.C), g.c_sm,
                           g.c_sn, m, n, p1[mt][nf][q], p2[mt][nf][q],
                           p3[mt][nf][q], alr, ali, ber, bei);
      }
    }
}

template <typename T, int BM, int BN, int BK>
__device__ __forceinline__ void tile(unsigned char* smem_raw,
                                     const Args& g, int m0, int m_hi,
                                     int n0, int n_hi) {
  if constexpr (sizeof(T) == 8)
    tile_z<BM, BN, BK>(smem_raw, g, m0, m_hi, n0, n_hi);
  else
    tile_c<BM, BN, BK>(smem_raw, g, m0, m_hi, n0, n_hi);
}

template <typename T>
__global__ void __launch_bounds__(NT, 2) cx_gemm_kernel(const Table t, Args g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the block's region: the last whose first block is at or before it
  // (the table is read at fixed offsets only, so it stays in the
  // parameter bank)
  const int bid = blockIdx.x;
  Region reg = t.r[0];
#pragma unroll
  for (int i = 1; i < MAX_REGIONS; ++i) {
    if (i >= t.n || bid < t.r[i].start) break;
    reg = t.r[i];
  }
  const int local = bid - reg.start;
  const int m0 = reg.m0 + (local / reg.gn) * reg.bm;
  const int n0 = reg.n0 + (local % reg.gn) * reg.bn;
#define IAAT_INSTANCE(BM, BN, BK)                                      \
  if (reg.bm == BM && reg.bn == BN && reg.bk == BK) {                  \
    tile<T, BM, BN, BK>(smem_raw, g, m0, reg.m_hi, n0, reg.n_hi);      \
    return;                                                            \
  }
#include IAAT_TABLE
#undef IAAT_INSTANCE
}

// Shared bytes of instance (bm, bn, bk), 0 if it is none of the table.
size_t smem_of(int bm, int bn, int bk) {
#define IAAT_INSTANCE(BM, BN, BK) \
  if (bm == BM && bn == BN && bk == BK) return CxRing<Elem, BM, BN, BK>::SMEM;
#include IAAT_TABLE
#undef IAAT_INSTANCE
  return 0;
}

size_t smem_max() {
  size_t m = 0;
#define IAAT_INSTANCE(BM, BN, BK) \
  m = CxRing<Elem, BM, BN, BK>::SMEM > m ? CxRing<Elem, BM, BN, BK>::SMEM : m;
#include IAAT_TABLE
#undef IAAT_INSTANCE
  return m;
}

}  // namespace

// One launch over nreg regions; table holds nreg rows of 9 ints (start,
// m0, m_hi, n0, n_hi, gn, bm, bn, bk), as Plan.launch_tables lists them.
// Strides are in complex elements (a complex tensor's own strides).
// Returns 0 on success, a cudaError_t code if the launch failed, and -1
// when the table is empty, longer than MAX_REGIONS, or names a block
// that is not an instance of the installed table.
extern "C" int IAAT_NAME(cx_gemm)(const int* table, int nreg,
                                  const void* a, long long a_sm, long long a_sk,
                                  const void* b, long long b_sk, long long b_sn,
                                  const void* c, long long c_sm, long long c_sn,
                                  void* o, long long o_sm, long long o_sn,
                                  int K, double alpha_r, double alpha_i,
                                  double beta_r, double beta_i,
                                  void* stream) {
  if (nreg < 1 || nreg > MAX_REGIONS || K < 1) return -1;
  Table t;
  t.n = nreg;
  size_t smem = 0;
  int blocks = 0;
  for (int i = 0; i < nreg; ++i) {
    const int* row = table + 9 * i;
    Region& r = t.r[i];
    r.start = row[0];
    r.m0 = row[1];
    r.m_hi = row[2];
    r.n0 = row[3];
    r.n_hi = row[4];
    r.gn = row[5];
    r.bm = row[6];
    r.bn = row[7];
    r.bk = row[8];
    const size_t s = smem_of(r.bm, r.bn, r.bk);
    if (s == 0 || r.start != blocks || r.gn < 1) return -1;
    smem = s > smem ? s : smem;
    blocks += ((r.m_hi - r.m0 + r.bm - 1) / r.bm) * r.gn;
  }
  void (*kern)(const Table, Args) = cx_gemm_kernel<Elem>;
  // opt in once to the most shared memory any instance takes
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_max());
  if (attr != cudaSuccess) return attr;
  Args g{a, a_sm, a_sk, b, b_sk, b_sn, c, c_sm, c_sn, o, o_sm, o_sn, K,
         alpha_r, alpha_i, beta_r, beta_i};
  kern<<<blocks, NT, smem, static_cast<cudaStream_t>(stream)>>>(t, g);
  return (int)cudaGetLastError();
}
