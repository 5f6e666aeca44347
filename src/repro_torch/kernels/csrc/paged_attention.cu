// Attention over a paged KV pool for Hopper (sm_90a), plain C interface.
//
// Replaces no TPU kernel.  The reference attends over its paged pool in
// plain jnp (repro/models/layers.py::paged_attend): it gathers the whole
// block table, widens it and runs two einsums, which XLA fuses on the
// TPU.  Ported as plain torch ops, that gather, the permute copies, the f32
// widening of the gathered table and the f32 products took most of a
// serving step's device time and one blocking host-to-device copy a layer
// (PERF.md §5).  This kernel computes the same function in one launch a
// layer and model call, reading K and V where they live.
//
// q (B, H, C, D) and o (B, H, C, D), each read or written through its four
// strides; k and v pools (P, Hkv, BS, D), a block's BS x D of one kv head
// contiguous (the pool id and the kv head through strides); the block
// table (B, nmax) and q_pos (B, C), int64, through their strides; and
// decode_from (B,) int64, or null.  Flattened key j of a slot's table is
// its sequence position j; row (b, h, c) sees keys j <= q_pos[b, c], and
// with a window also j > q_pos[b, c] - window.  Everything the kernel
// needs it reads on the device: no host read, no sync.
//
// What bounds it on an H100: a decode row does 4 D flops for each key it
// reads (2 D bytes of K and 2 D of V), under 1 flop a byte, far below the
// bf16 ridge of ~295, so the card's bound is the bytes of the live K/V
// blocks (3.35 TB/s).  What the design does about them:
//   * one block of NT = 128 threads per (slot, kv head, group of up to
//     MAX_ROWS query rows): rows are ordered (c, r), r the head within
//     the GQA group, so the rep = H / Hkv heads of a group (and, in a
//     prefill chunk, neighbouring positions) share each K/V block read;
//   * it visits only the table's blocks its rows can reach, from
//     max(0, q_pos - window + 1) / BS to q_pos / BS, never the padding
//     past a slot's length nor the null blocks there;
//   * each block (BS x D bf16, 4 KB at BS 16, D 128) arrives whole in a
//     STAGES-deep ring of 16-byte cp.async copies, so the next blocks'
//     loads are in flight while the current one is used.
//
// The arithmetic is the plain path's, in its order (DESIGN_PORT.md §15):
//   1. scores: s = (q . k) * scale, bf16 operands, products exact in f32,
//      summed in f32 (each lane over D / 32 elements, then a shuffle
//      tree: the only order that differs from the plain path's), kept in
//      shared memory for the row's whole key range, or recomputed tile by
//      tile where that range does not fit (below);
//   2. the full row's max m over its visible keys, e = exp(s - m) (expf,
//      no approximate exponent), masked keys 0, l = sum of the unrounded
//      e; then per row, as the plain path chooses (decode rows: C == 1,
//      or q_pos >= decode_from): p = bf16(e / l) (the normalised softmax,
//      rounded as p.to(bf16)), else p = bf16(e) (the flash order);
//   3. acc = sum over the same blocks of p * v in f32; decode rows store
//      bf16(acc), the others bf16(acc / max(l, 1e-37)).
// No online rescaling: the max is known before any exponent is taken.
//
// Shared memory: the ring STAGES x BS x D bf16, the group's q rows in f32
// (rows x D) and the scores of a tile of at most tile_blocks table blocks
// (rows x tile_blocks x BS f32).  The wrapper (kernels/paged_attention.py)
// halves the rows a block holds until the whole table's scores fit; where
// even one row's do not (past about 50k keys), it passes the most blocks
// that fit as tile_blocks, and the kernel takes the range in tiles, each
// scored again in each of three passes over K (the max, then l, then
// p and P V over V once).  The scores are recomputed bit for bit, so the
// order of the arithmetic above is the same; only l is summed tile by tile.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NT = 128;
constexpr int NWARP = NT / 32;
constexpr int STAGES = 4;
constexpr int MAX_ROWS = 8;  // rows a block holds: 1, 2, 4 or 8

struct Params {
  const __nv_bfloat16* q;
  long long q_s[4];
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  long long pool_sp, pool_sh;  // strides of a pool id and of a kv head
  const long long* table;
  long long table_sb, table_sn;
  const long long* qpos;
  long long qpos_sb, qpos_sc;
  const long long* dfrom;      // null: no replay rows
  long long dfrom_sb;
  __nv_bfloat16* o;
  long long o_s[4];
  int H, Hkv, C, BS, nmax, window;
  int tile_blocks;  // the most table blocks whose scores a block holds
  float scale;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// E consecutive bf16 of shared memory (4, 8 or 16 bytes), widened
template <int E>
__device__ __forceinline__ void load_row(float (&out)[E],
                                         const __nv_bfloat16* src) {
  static_assert(E == 2 || E == 4 || E == 8, "E is D / 32");
  if constexpr (E == 2) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(src));
    out[0] = f.x;
    out[1] = f.y;
  } else {
    typedef typename std::conditional<E == 4, uint2, uint4>::type Vec;
    const Vec raw = *reinterpret_cast<const Vec*>(src);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < E / 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
}

// Streams the table blocks [blo, blo + nb) of kv head g of slot b from
// `pool` through the ring, calling body(stage, t) on block blo + t once it
// has landed; every thread takes part.
template <int D, typename Body>
__device__ __forceinline__ void stream_blocks(const Params& p,
                                              const __nv_bfloat16* pool,
                                              __nv_bfloat16* ring, int b,
                                              int g, int blo, int nb,
                                              Body&& body) {
  const int stage_elems = p.BS * D;
  auto issue = [&](int t) {
    const long long pid =
        p.table[b * p.table_sb + (long long)(blo + t) * p.table_sn];
    const __nv_bfloat16* src = pool + pid * p.pool_sp + g * p.pool_sh;
    __nv_bfloat16* dst = ring + (t % STAGES) * stage_elems;
    for (int e = threadIdx.x * 8; e < stage_elems; e += NT * 8)
      cp_async16(dst + e, src + e);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nb) issue(s);
    cp_async_commit();
  }
  for (int t = 0; t < nb; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    // the stage refilled here was last read at t - 1, which every thread
    // has finished: it passed the barrier above
    if (t + STAGES - 1 < nb) issue(t + STAGES - 1);
    cp_async_commit();
    body(ring + (t % STAGES) * stage_elems, t);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// ROWS: the rows a block holds (the last block of a slot and kv head may
// hold fewer)
template <int D, int ROWS>
__global__ void __launch_bounds__(NT)
    paged_attention_kernel(const Params p) {
  constexpr int E = D / 32;             // a lane's share of a key's dot
  constexpr int TD = D < NT ? D : NT;   // threads along D in P V
  constexpr int RG = NT / TD;           // row groups in P V
  constexpr int DPT = D / TD;           // columns a thread holds in P V
  constexpr int RPT = (ROWS + RG - 1) / RG;  // rows a thread holds in P V
  const int b = blockIdx.z, g = blockIdx.y;
  const int rep = p.H / p.Hkv;
  const int row0 = blockIdx.x * ROWS;
  const int R = min(ROWS, rep * p.C - row0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int span = p.nmax * p.BS;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  float* qs = reinterpret_cast<float*>(smem + (size_t)STAGES * p.BS * D * 2);
  float* sc = qs + ROWS * D;
  __shared__ int s_lo[ROWS], s_hi[ROWS], s_dec[ROWS];
  __shared__ float s_m[ROWS], s_l[ROWS];
  __shared__ int s_blo, s_nb;

  // each row's visible keys [lo, hi] (empty where hi < lo) and its order
  if (tid < R) {
    const int c = (row0 + tid) / rep;
    const long long qp = p.qpos[b * p.qpos_sb + c * p.qpos_sc];
    const long long hi = qp < span - 1 ? qp : span - 1;
    long long lo = 0;
    if (p.window > 0 && qp - p.window + 1 > 0) lo = qp - p.window + 1;
    s_lo[tid] = (int)lo;
    s_hi[tid] = (int)(hi < lo ? lo - 1 : hi);
    s_dec[tid] = p.C == 1 ||
                 (p.dfrom != nullptr && qp >= p.dfrom[b * p.dfrom_sb]);
  }
  for (int e = tid; e < R * D; e += NT) {
    const int ri = e / D, d = e % D;
    const int c = (row0 + ri) / rep, h = g * rep + (row0 + ri) % rep;
    qs[ri * D + d] = __bfloat162float(
        p.q[b * p.q_s[0] + h * p.q_s[1] + c * p.q_s[2] + d * p.q_s[3]]);
  }
  __syncthreads();
  if (tid == 0) {
    int blo = p.nmax, bhi = -1;
    for (int ri = 0; ri < R; ++ri) {
      if (s_hi[ri] < s_lo[ri]) continue;
      blo = min(blo, s_lo[ri] / p.BS);
      bhi = max(bhi, s_hi[ri] / p.BS);
    }
    s_blo = blo;
    s_nb = bhi >= blo ? bhi - blo + 1 : 0;
  }
  __syncthreads();
  const int blo = s_blo, nb = s_nb;
  const int key0 = blo * p.BS;

  // The blocks' range in tiles of at most tile_blocks blocks, the most
  // whose scores fit shared memory.  One tile (every table the chat cell
  // serves): score, softmax, P V.  More (a table past about 50k keys at
  // one row a block): the scores are recomputed, bit for bit, in three
  // passes over K, for the max, for l and for P V, so the max is still
  // the whole row's before any exponent is taken.
  const int TB = p.tile_blocks;
  const int ntile = (nb + TB - 1) / TB;
  const int ld = min(nb, TB) * p.BS;  // a row's stride in the scores

  // scores of every row against every key of the tile's blocks
  auto score = [&](int tile) {
    const int tb0 = blo + tile * TB, tnb = min(TB, nb - tile * TB);
    stream_blocks<D>(p, p.k, ring, b, g, tb0, tnb,
                     [&](const __nv_bfloat16* kt, int t) {
      for (int kk = warp; kk < p.BS; kk += NWARP) {
        float kf[E];
        load_row<E>(kf, kt + kk * D + lane * E);
        for (int ri = 0; ri < R; ++ri) {
          const float* qr = qs + ri * D + lane * E;
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) dot = fmaf(qr[e], kf[e], dot);
          dot = warp_sum(dot);
          if (lane == 0) sc[ri * ld + t * p.BS + kk] = dot * p.scale;
        }
      }
    });
  };
  // row ri's visible keys inside the tile, [lo, hi] as tile offsets
  auto visible = [&](int ri, int tile, int& lo, int& hi) {
    const int k0 = key0 + tile * TB * p.BS;
    lo = max(s_lo[ri] - k0, 0);
    hi = min(s_hi[ri] - k0, min(TB, nb - tile * TB) * p.BS - 1);
  };

  // P V over the tile's blocks, into acc
  const int d0 = tid % TD, rg = tid / TD;
  float acc[RPT][DPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k)
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[k][e] = 0.f;
  auto pv = [&](int tile) {
    const int tb0 = blo + tile * TB, tnb = min(TB, nb - tile * TB);
    stream_blocks<D>(p, p.v, ring, b, g, tb0, tnb,
                     [&](const __nv_bfloat16* vt, int t) {
      for (int kk = 0; kk < p.BS; ++kk) {
        float vv[DPT];
#pragma unroll
        for (int e = 0; e < DPT; ++e)
          vv[e] = __bfloat162float(vt[kk * D + d0 + e * TD]);
        const float* pcol = sc + t * p.BS + kk;
#pragma unroll
        for (int k = 0; k < RPT; ++k) {
          const int ri = rg + k * RG;
          if (ri < R) {
            const float pr = pcol[ri * ld];
#pragma unroll
            for (int e = 0; e < DPT; ++e)
              acc[k][e] = fmaf(pr, vv[e], acc[k][e]);
          }
        }
      }
    });
  };

  if (ntile <= 1) {
    score(0);
    // per row: the max over its visible keys, then its probabilities
    for (int ri = warp; ri < R; ri += NWARP) {
      int lo, hi;
      visible(ri, 0, lo, hi);
      float* row = sc + ri * ld;
      float m = -INFINITY;
      for (int t = lo + lane; t <= hi; t += 32) m = fmaxf(m, row[t]);
      m = warp_max(m);
      float l = 0.f;
      for (int t = lane; t < ld; t += 32) {
        const float e = (t >= lo && t <= hi) ? expf(row[t] - m) : 0.f;
        row[t] = e;
        l += e;
      }
      l = warp_sum(l);
      const bool dec = s_dec[ri];
      // each lane rewrites the entries it wrote above
      for (int t = lane; t < ld; t += 32)
        row[t] = __bfloat162float(
            __float2bfloat16(dec ? row[t] / l : row[t]));
      if (lane == 0) s_l[ri] = l;
    }
    __syncthreads();
    pv(0);
  } else {
    // a row's m and l live in shared memory, each written by lane 0 of
    // the one warp that owns the row; score's barriers order the passes
    for (int tile = 0; tile < ntile; ++tile) {
      score(tile);
      for (int ri = warp; ri < R; ri += NWARP) {
        int lo, hi;
        visible(ri, tile, lo, hi);
        const float* row = sc + ri * ld;
        float m = -INFINITY;
        for (int t = lo + lane; t <= hi; t += 32) m = fmaxf(m, row[t]);
        m = warp_max(m);
        if (lane == 0) s_m[ri] = tile ? fmaxf(s_m[ri], m) : m;
      }
    }
    for (int tile = 0; tile < ntile; ++tile) {
      score(tile);
      for (int ri = warp; ri < R; ri += NWARP) {
        int lo, hi;
        visible(ri, tile, lo, hi);
        const float* row = sc + ri * ld;
        const float m = s_m[ri];
        float l = 0.f;
        for (int t = lo + lane; t <= hi; t += 32) l += expf(row[t] - m);
        l = warp_sum(l);
        if (lane == 0) s_l[ri] = tile ? s_l[ri] + l : l;
      }
    }
    for (int tile = 0; tile < ntile; ++tile) {
      score(tile);
      for (int ri = warp; ri < R; ri += NWARP) {
        int lo, hi;
        visible(ri, tile, lo, hi);
        float* row = sc + ri * ld;
        const float m = s_m[ri], l = s_l[ri];
        const bool dec = s_dec[ri];
        for (int t = lane; t < ld; t += 32) {
          const float e = (t >= lo && t <= hi) ? expf(row[t] - m) : 0.f;
          row[t] = __bfloat162float(__float2bfloat16(dec ? e / l : e));
        }
      }
      __syncthreads();
      pv(tile);
    }
  }

#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int ri = rg + k * RG;
    if (ri >= R) continue;
    const int c = (row0 + ri) / rep, h = g * rep + (row0 + ri) % rep;
    const bool dec = s_dec[ri];
    const float den = fmaxf(s_l[ri], 1e-37f);
#pragma unroll
    for (int e = 0; e < DPT; ++e) {
      const int d = d0 + e * TD;
      const float val = dec ? acc[k][e] : acc[k][e] / den;
      p.o[b * p.o_s[0] + h * p.o_s[1] + c * p.o_s[2] + d * p.o_s[3]] =
          __float2bfloat16(val);
    }
  }
}

template <int D, int ROWS>
cudaError_t launch(const Params& p, int B, size_t smem, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<D, ROWS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int rows = (p.H / p.Hkv) * p.C;
  const dim3 grid((rows + ROWS - 1) / ROWS, p.Hkv, B);
  paged_attention_kernel<D, ROWS><<<grid, NT, smem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Returns 0 on success, a cudaError_t code if the launch failed, and -1
// when (D, rows) is not an instance: D in {64, 128, 256}, rows in
// {1, 2, 4, 8}.
extern "C" int paged_attention(
    int D, const void* q, const long long* q_strides, const void* k_pool,
    const void* v_pool, long long pool_sp, long long pool_sh,
    const void* table, long long table_sb, long long table_sn,
    const void* qpos, long long qpos_sb, long long qpos_sc,
    const void* dfrom, long long dfrom_sb, void* o,
    const long long* o_strides, int B, int H, int Hkv, int C, int BS,
    int nmax, int rows, int tile_blocks, int window, float scale,
    long long smem, void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k_pool);
  p.v = static_cast<const __nv_bfloat16*>(v_pool);
  p.o = static_cast<__nv_bfloat16*>(o);
  for (int i = 0; i < 4; ++i) {
    p.q_s[i] = q_strides[i];
    p.o_s[i] = o_strides[i];
  }
  p.pool_sp = pool_sp;
  p.pool_sh = pool_sh;
  p.table = static_cast<const long long*>(table);
  p.table_sb = table_sb;
  p.table_sn = table_sn;
  p.qpos = static_cast<const long long*>(qpos);
  p.qpos_sb = qpos_sb;
  p.qpos_sc = qpos_sc;
  p.dfrom = static_cast<const long long*>(dfrom);
  p.dfrom_sb = dfrom_sb;
  p.H = H;
  p.Hkv = Hkv;
  p.C = C;
  p.BS = BS;
  p.nmax = nmax;
  p.window = window;
  p.tile_blocks = tile_blocks;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PAGED_INSTANCE(HD, ROWS)                                  \
  if (D == HD && rows == ROWS)                                    \
    return (int)launch<HD, ROWS>(p, B, (size_t)smem, st);
#define PAGED_ROWS(HD)                                            \
  PAGED_INSTANCE(HD, 1)                                           \
  PAGED_INSTANCE(HD, 2)                                           \
  PAGED_INSTANCE(HD, 4)                                           \
  PAGED_INSTANCE(HD, MAX_ROWS)
  PAGED_ROWS(64)
  PAGED_ROWS(128)
  PAGED_ROWS(256)
#undef PAGED_ROWS
#undef PAGED_INSTANCE
  return -1;
}
