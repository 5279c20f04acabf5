// B1 — fused RMSNorm + QKV-Projection + RoPE + ragged decode attention +
// per-head Output-Projection ("partial_o"), one launch for all B slots.
//
// Replaces repro/kernels/fused_decode/fused_decode.py:fused_decode_attention
// (the Pallas kernel at its pallas_call, line 374) in the serving mode:
// fused ln1, an optional q/k/v bias (Qwen2-72B's), q_per_kv = nq / nkv
// query heads a kv head (1 = MHA; GQA and MQA above), hd 128 — or hd 256
// at MQA 16/1 (RecurrentGemma-9B's
// local layers), or hd 64 at MHA (SeamlessM4T-medium's decoder) —, on a
// linear cache or a sliding window over a ring
// cache (Gemma-2's and RecurrentGemma's local layers), with or without
// the attention softcap.
//
// Bound on an H100: bytes.  Per layer the weights (wqkv + wo: 134 MB at
// Llama2-7B, 84 MB at Granite-8B, 71 MB at RecurrentGemma-9B) and each
// slot's live KV are read once; the arithmetic is a few FLOPs per byte.
// Design, the paper's (Alg. 1-3): one thread-block cluster of C CTAs per
// group of H query heads of kv head g — at hd 128 H = q_per_kv, one
// cluster per kv head (the wrapper's plan: C = 4, H = 1 at Llama2-7B, 128
// CTAs; C = 8, H = 4 and 3 at Granite-8B and Minitron-4B, 64 CTAs; C = 4,
// H = 2 at Gemma-2 27B, 64 CTAs: its 16 clusters of 8 would be one more
// than the 15 an H100 runs at once, and measured slower; at q_per_kv 8,
// Qwen2-72B's, H = 2 of a kv head's 8 query heads, clusters of 8 of 1024
// rows a rank at d_model 8192: the wqkv ring of 8 heads a cluster would
// not fit the shared memory, 4 heads a cluster (with a two-stage wo
// ring) ran 26-29 % slower at a mesh rank's 16/2 and 8/1 heads, and four
// clusters a kv head each read its rows again); at hd 256 and
// MQA 16/1 H = 2 of the kv head's 16 query heads, 8 clusters of 8 (64
// CTAs): one cluster for all 16 would need ~740 KB of shared memory for
// its wqkv ring, and 8 CTAs could not stream the layer; each of the 8
// clusters projects the kv head's k and v again and attends the same
// rows (the second reads mostly hit L2, PERF.md §6); at hd 64 and MHA
// H = 1, one cluster a head (SeamlessM4T-medium's 16/16 at D 1024: 16
// clusters of 4, 64 CTAs, 256 rows a rank) —, the grid and the buffers
// laid out by query-head group.
// Rank r of the cluster of query heads qb .. qb + H − 1 (kv head g)
//   1. normalizes x for all B slots (the sum of squares over the whole
//      row, redundant per rank: 64 KB from L2) and keeps its rows
//      [r·D/C, (r+1)·D/C) in shared memory, rounded to bf16 as the
//      reference rounds before the projection;
//   2. streams those rows of the group's wqkv columns — its H query heads,
//      then k and v of head g: (H + 2)·hd columns — ONCE through a
//      cp.async ring of 16-row tiles (five stages, three at hd 256 with
//      two heads: 16-byte copies, the other tiles in flight while one is
//      computed) and multiplies them on the tensor cores (mma.sync
//      m16n8k16; H = 1: the B ≤ 8 normed rows, exact in bf16, as the
//      16-row A operand, each warp (H + 2)·hd / 8 columns — 24 at hd 64,
//      three n tiles, the last loaded alone; H > 1: the
//      weight tile as A and the slots as n, so no MMA row is padding);
//   3. ClusterReduce: the [B, (H + 2)·hd] f32 partials are summed in rank
//      order, each rank its slice over DSMEM (cluster::sum), then gathered
//      (cluster::gather), so every rank holds the same q, k and v;
//   4. adds the bias (bqkv, bf16, in f32: the reference's order, after
//      the projection and before RoPE) where given; applies RoPE in f32;
//      rank 0 of the kv head's first cluster writes the rounded
//      k_new/v_new;
//   5. attends over its share of the rows [0, L) of each slot, L =
//      clamp(cache_len − max(pos_base, 0), 0, S) (pos_base: the first
//      position of this shard of a cluster across devices, r·S on its
//      rank r; 0 on one device; −1 on a ring shard, whose offsets are
//      not positions) — run r of C of equal length: a slot's split
//      depends on its own length alone —, rows with pos in [0, cache_len) and, with a
//      window, pos > cache_len − window (by stored pos: on a wrapped ring
//      the row the append will overwrite still holds cache_len − S, and
//      offsets are not positions, so no row is culled by its offset);
//      scores softcapped (tanh(s/cap)·cap) before the softmax; streaming K/V
//      and pos through a cp.async ring (its first tiles load during step
//      3); a tile holds one slot's rows, which that slot's H query heads
//      attend: each warp scores 32 / (hd / 32) keys of a tile (hd / 32
//      lanes a key: 8 keys of a 64-row tile at hd 128, 4 of a 32-row one
//      at hd 256, 16 of a 128-row one at hd 64) for all H heads (each K
//      and V element read once from
//      shared memory for the H heads) and keeps its own online softmax
//      per head from m = -1e30, the eight warps' partials merging in warp
//      order at a slot's end (no barrier inside a tile);
//   6. ClusterReduce with the flash-merge operator: the ranks' (m, l, acc)
//      of every (slot, head) merge in rank order over DSMEM, identically
//      on every rank (H = 1: cluster::flash_merge; H > 1: each rank merges
//      its slice of the rows with the operator's factors, then the ranks
//      gather the slices);
//   7. folds in the new token (f32 k/v, gated by include_new, its score
//      softcapped like the cached rows') the same way on every rank; rank
//      0 writes m and l;
//   8. projects each head's acc through columns [r·D/C, (r+1)·D/C) of its
//      wo[h] (a cp.async ring over the H heads' rows) on the tensor
//      cores, acc split into bf16 hi + lo terms (two mma.sync each: acc
//      kept to ~2^-17; H > 1: the wo tile as A, acc as B), into its slice
//      of o[b, h, :] (unnormalized).
// Every weight byte and every live KV row is read once for the grid;
// partials are summed in a fixed order, with no float atomics.  At H = 1 every step is
// the MHA kernel's arithmetic, in its order.
#include "cluster.cuh"

// FD_STAMP(i): a hook at the end of phase i (0 = the kernel's start); a
// build that defines it (scripts/b1_phases.py) records the time there
#ifndef FD_STAMP
#define FD_STAMP(i)
#endif

namespace {

// the attention softcap of a scaled score (none at cap 0)
DEVI float softcap(float s, float cap) {
  return cap > 0.f ? tanhf(s / cap) * cap : s;
}

constexpr int NT = 256;        // 8 warps
constexpr int NW = NT / 32;
constexpr int BP = 8;          // slots as laid out in shared memory
constexpr int TRW = 16;        // wqkv rows a tile: one k16 step
// wqkv ring stages: five; three at hd 256 with two heads a cluster, whose
// 1024-column tiles leave room for no more beside the other buffers
template <int H, int HD>
constexpr int WST = HD == 256 && H > 1 ? 3 : 5;
// lanes that score one cache row (each 32 of its hd elements): 2 at hd
// 64, 4 at hd 128, 8 at hd 256; a warp scores 32 / LPK rows of a tile, so
// a tile holds NT / LPK rows: 128 at hd 64, 64 at hd 128, 32 at hd 256
template <int HD>
constexpr int LPK = HD / 32;
template <int HD>
constexpr int TRA = NT / LPK<HD>;   // cache rows a tile
template <int HD>
constexpr int RSA = HD + 8;         // padded cache row (bf16)
// cache ring stages: two for one head; three for H heads, whose tiles
// take longer to score (the ring fits in region 0 beside the larger wqkv
// ring)
template <int H>
constexpr int AST = H == 1 ? 2 : 3;
// wo rows a tile: one k16 step for one head; two for H heads, whose 8·H
// k16 steps would otherwise each pay a tile's wait, barrier and issue
template <int H>
constexpr int TRO = H == 1 ? 16 : 32;
// wo ring stages: two for one head (its 8 tiles), four for H ≥ 3 heads'
// 4·H tiles, so three tiles stay in flight (the ring fits in region 0
// beside the larger wqkv ring); two for two heads, whose plan gives a rank
// 1152 rows (Gemma-2 27B: four such stages would not fit)
template <int H>
constexpr int OST = H <= 2 ? 2 : 4;
template <int HD>
constexpr int ACS = HD + 4;    // acc row stride (f32)
// wo n tiles a warp: Dr ≤ 1152 (Gemma-2 27B's 4608 / 4) for two heads,
// ≤ 1024 for the others
template <int H>
constexpr int MAX_NTO = H == 2 ? 18 : 16;
constexpr int MAX_C = 8;       // ranks a cluster (the portable size)

__host__ __device__ constexpr size_t smax(size_t a, size_t b) {
  return a > b ? a : b;
}

// Shared-memory layout for Dr = D / C rows a rank and H query heads a
// cluster of head dim HD: NC = (H + 2)·HD columns of wqkv (the H heads'
// q, then k, v).
template <int B, int H, int HD>
struct Lay {
  static constexpr int NC = (H + 2) * HD;
  static constexpr int NCP = NC + 8;        // padded wqkv tile row (bf16)
  static constexpr int R = B * H;           // (slot, head) rows
  int Dr;
  __host__ __device__ int xrow() const { return Dr + 8; }   // bf16, padded
  // region 0, reused phase by phase: the wqkv ring, the cache ring, the
  // wo ring
  __host__ __device__ size_t r0() const {
    size_t s = (size_t)WST<H, HD> * TRW * NCP * 2;
    s = smax(s, (size_t)AST<H> * 2 * TRA<HD> * RSA<HD> * 2);
    return smax(s, (size_t)OST<H> * TRO<H> * xrow() * 2);
  }
  // the normed rows bf16 [BP][xrow], then the projection's partial f32
  // [B][NC], then the warps' attention partials f32 [NW][H][4 + HD]
  __host__ __device__ size_t xs() const { return r0(); }
  __host__ __device__ size_t qkv() const {
    return xs() + smax(smax((size_t)BP * xrow() * 2, (size_t)B * NC * 4),
                       (size_t)NW * H * (4 + HD) * 4);
  }
  // this rank's attention partial m[R], l[R], acc[R][HD], row b·H + h
  __host__ __device__ size_t apart() const { return qkv() + (size_t)B * NC * 4; }
  // the merged acc f32 [BP·H][ACS]
  __host__ __device__ size_t acc2() const {
    return apart() + (size_t)(cluster::acc_offset(R) + R * HD) * 4;
  }
  __host__ __device__ size_t misc() const {
    return acc2() + (size_t)BP * H * ACS<HD> * 4;
  }
  // misc: red_ss[NW·BP] inv[BP] mfin lfin cn pn [BP·H]; ints sa se clen
  //       [BP] first[BP + 1] pos tiles [AST][TRA]
  __host__ __device__ size_t total() const {
    return misc() + (size_t)(NW * BP + BP + 4 * BP * H) * 4
         + (size_t)(4 * BP + 4 + AST<H> * TRA<HD>) * 4;
  }
};

// one head a cluster at hd 128: at most 128 registers (two CTAs an SM
// fit); more heads, or hd 256: the per-head attention state and one CTA
// an SM (its shared memory holds no second one)
template <int B, int H, int HD>
__global__ void __launch_bounds__(NT, H == 1 && HD == 128 ? 2 : 1)
fused_decode_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wqkv,
                    const bf16* __restrict__ wo, const float* __restrict__ ln1,
                    const bf16* __restrict__ kc, const bf16* __restrict__ vc,
                    const int* __restrict__ pos, const int* __restrict__ cache_lens,
                    const int* __restrict__ include_new,
                    const float* __restrict__ cosv, const float* __restrict__ sinv,
                    const bf16* __restrict__ bqkv,
                    float* __restrict__ o, bf16* __restrict__ k_new,
                    bf16* __restrict__ v_new, float* __restrict__ m_out,
                    float* __restrict__ l_out, int D, int S, int nq, int nkv,
                    int window, int pos_base, float scale, float eps, float cap) {
  using L_ = Lay<B, H, HD>;
  constexpr int NC = L_::NC, NCP = L_::NCP, R = L_::R;
  constexpr int NTW = NC / 8 / NW;   // 8-column n tiles a warp projects
  constexpr int AS = AST<H>;
  constexpr int WS = WST<H, HD>;
  constexpr int TA = TRA<HD>, RS = RSA<HD>, AC = ACS<HD>;
  const int C = (int)cooperative_groups::this_cluster().num_blocks();
  // cluster ci holds query heads qb .. qb + H − 1 of kv head g (at hd
  // 128 H = q_per_kv: ci = g)
  const int rank = blockIdx.x % C, ci = blockIdx.x / C, qb = ci * H;
  const int g = qb / (nq / nkv);
  const L_ L{D / C};
  const int Dr = L.Dr, d0 = rank * Dr, xrow = L.xrow();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gi = lane >> 2, ti = lane & 3, mi = lane >> 3;   // fragments
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* r0 = smem;
  bf16* xs = reinterpret_cast<bf16*>(smem + L.xs());
  float* part = reinterpret_cast<float*>(smem + L.xs());   // after phase 2
  float* qkv = reinterpret_cast<float*>(smem + L.qkv());
  float* am = reinterpret_cast<float*>(smem + L.apart());
  float* al = am + R;
  float* aacc = am + cluster::acc_offset(R);
  float* acc2 = reinterpret_cast<float*>(smem + L.acc2());
  float* red_ss = reinterpret_cast<float*>(smem + L.misc());
  float* inv = red_ss + NW * BP;
  float* mfin = inv + BP;
  float* lfin = mfin + BP * H;
  float* cn = lfin + BP * H;
  float* pn = cn + BP * H;
  int* sa = reinterpret_cast<int*>(pn + BP * H);
  int* se = sa + BP;
  int* clen = se + BP;
  int* first = clen + BP;            // [BP + 1] prefix of tiles by slot
  int* posb = first + BP + 4;        // [AS][TA]
  FD_STAMP(0);

  // ---- phase 2 prologue: the first wqkv tiles go in flight at once ----
  const int P = (nq + 2 * nkv) * HD;
  const int ntw = Dr / TRW;
  bf16* ring_w = reinterpret_cast<bf16*>(r0);
  auto load_w = [&](int t) {
    bf16* dst = ring_w + (size_t)(t % WS) * TRW * NCP;
    const int rb = t * TRW;
    for (int i = tid; i < TRW * (NC / 8); i += NT) {
      const int p = i / (NC / 8), j = i % (NC / 8), c = j * 8;
      // the H query heads' columns, then k and v of kv head g
      const int col = c < H * HD ? qb * HD + c
                    : (c < (H + 1) * HD ? (nq + g) * HD + c - H * HD
                                        : (nq + nkv + g) * HD + c - (H + 1) * HD);
      cp_async16(dst + p * NCP + c, wqkv + (size_t)(d0 + rb + p) * P + col);
    }
  };
#pragma unroll
  for (int t = 0; t < WS - 1; ++t) {
    if (t < ntw) load_w(t);
    cp_async_commit();
  }

  // this rank's share of the live rows: each slot's rows [0, L_b) cut
  // into C runs of equal length, rank r taking run r, in tiles of TA
  // rows — a slot's split depends on its own length alone, so its bits
  // do not depend on the other slots (what a recovery replay needs).
  // L_b counts from the shard's first position: a slot whose positions
  // all lie before this shard reads nothing here, and unless it owns its
  // new token its partial is the free slot's (m −1e30, the new token at
  // weight exp(0) = 1), which the combine over the shards weighs 0
  if (tid < BP) clen[tid] = tid < B ? cache_lens[tid] : 0;
  __syncthreads();
  if (tid == 0) {
    int f = 0;
    for (int b = 0; b < BP; ++b) {
      const int cl = clen[b] - (pos_base > 0 ? pos_base : 0);
      const int L = cl < 0 ? 0 : (cl < S ? cl : S);
      const int per = (L + C - 1) / C;
      sa[b] = min(L, rank * per);
      se[b] = min(L, sa[b] + per);
      first[b] = f;
      f += (se[b] - sa[b] + TA - 1) / TA;
    }
    first[BP] = f;
  }

  // ---- phase 1: RMSNorm(x, ln1); this rank's rows, rounded to bf16 ----
  {
    // the sum of squares over the whole row; this rank's rows kept raw
    float ss[B];
#pragma unroll
    for (int b = 0; b < B; ++b) ss[b] = 0.f;
    for (int i = tid; i < D / 8; i += NT) {
      const bool mine = i * 8 >= d0 && i * 8 < d0 + Dr;
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(x + (size_t)b * D) + i);
        const float v8[8] = {lo_bf(u.x), hi_bf(u.x), lo_bf(u.y), hi_bf(u.y),
                             lo_bf(u.z), hi_bf(u.z), lo_bf(u.w), hi_bf(u.w)};
#pragma unroll
        for (int k = 0; k < 8; ++k) ss[b] += v8[k] * v8[k];
        if (mine) *reinterpret_cast<uint4*>(xs + b * xrow + i * 8 - d0) = u;
      }
    }
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const float s = warp_sum(ss[b]);
      if (lane == 0) red_ss[warp * BP + b] = s;
    }
    __syncthreads();
    if (tid < B) {
      float s = 0.f;
      for (int w = 0; w < NW; ++w) s += red_ss[w * BP + tid];
      inv[tid] = 1.0f / sqrtf(s / (float)D + eps);
    }
    __syncthreads();
    // eight rows a step; slots past B zero (the MMA's A rows)
    for (int i = tid; i < BP * (Dr / 8); i += NT) {
      const int b = i / (Dr / 8), c = (i % (Dr / 8)) * 8;
      bf16* xr = xs + b * xrow + c;
      if (b >= B) {
        *reinterpret_cast<uint4*>(xr) = make_uint4(0u, 0u, 0u, 0u);
        continue;
      }
      float v8[8];
      smem_bf16x8(xr, v8);
      const float4 ga = __ldg(reinterpret_cast<const float4*>(ln1 + d0 + c));
      const float4 gb = __ldg(reinterpret_cast<const float4*>(ln1 + d0 + c) + 1);
      const float gs[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
#pragma unroll
      for (int k = 0; k < 8; ++k) xr[k] = f2bf(v8[k] * inv[b] * (1.0f + gs[k]));
    }
  }

  FD_STAMP(1);

  // ---- phase 2: rows [d0, d0 + Dr) of the group's q|k|v columns -------
  // H = 1: warp w owns columns [w·NTW·8, (w + 1)·NTW·8) as NTW n tiles;
  // A = the normed rows (rows 8-15 of the m16 tile are zero: B ≤ 8).
  // H > 1: the wqkv tile is A (m tiles of 16 columns w, w + 8, …,
  // ldmatrix .trans of its [k][m] rows) and the normed rows are B (the
  // slots on n): no MMA row is padding, half the products.  Either way
  // this rank's [B][NC] partial (slots past B dropped) goes over xs.
  if constexpr (H == 1) {
    float cw[NTW][4];
#pragma unroll
    for (int n = 0; n < NTW; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) cw[n][j] = 0.f;
    for (int t = 0; t < ntw; ++t) {
      // tile t has landed, and no thread still reads the stage that tile
      // t + WS - 1 overwrites
      cp_async_wait<WS - 2>();
      __syncthreads();
      if (t + WS - 1 < ntw) load_w(t + WS - 1);
      cp_async_commit();
      const bf16* tile = ring_w + (size_t)(t % WS) * TRW * NCP;
      const bf16* xa = xs + gi * xrow + t * TRW + ti * 2;
      const uint32_t af[4] = {lds32(xa), 0u, lds32(xa + 8), 0u};
      const bf16* tb = tile + ((lane & 7) + (mi & 1) * 8) * NCP
                     + warp * NTW * 8 + (mi >> 1) * 8;
#pragma unroll
      for (int n = 0; n < NTW; n += 2) {
        if (n + 1 < NTW) {
          uint32_t bq[4];
          ldsm_x4_t(tb + n * 8, bq);
          mma_bf16(cw[n], af, bq[0], bq[1]);
          mma_bf16(cw[n + 1], af, bq[2], bq[3]);
        } else {                     // an odd last n tile (hd 64: NTW 3)
          uint32_t bq[2];
          ldsm_x2_t(tb + n * 8, bq);
          mma_bf16(cw[n], af, bq[0], bq[1]);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int n = 0; n < NTW; ++n)
      if (gi < B)
        *reinterpret_cast<float2*>(part + gi * NC + (warp * NTW + n) * 8 + ti * 2) =
            make_float2(cw[n][0], cw[n][1]);
  } else {
    constexpr int MT = NC / 16 / NW;   // m tiles a warp: H + 2
    const int ak = (lane & 7) + ((lane >> 4) << 3), amo = ((lane >> 3) & 1) << 3;
    float cp[MT][4];
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) cp[j][q] = 0.f;
    for (int t = 0; t < ntw; ++t) {
      cp_async_wait<WS - 2>();
      __syncthreads();
      if (t + WS - 1 < ntw) load_w(t + WS - 1);
      cp_async_commit();
      const bf16* tile = ring_w + (size_t)(t % WS) * TRW * NCP;
      const bf16* xb = xs + gi * xrow + t * TRW + ti * 2;
      const uint32_t b0 = lds32(xb), b1 = lds32(xb + 8);
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        uint32_t af[4];
        ldsm_x4_t(tile + ak * NCP + (warp + j * NW) * 16 + amo, af);
        mma_bf16(cp[j], af, b0, b1);
      }
    }
    cp_async_wait<0>();
    __syncthreads();
    // c0 c1: column gi of the m tile, slots 2·ti and 2·ti + 1; c2 c3:
    // column gi + 8
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      const int col = (warp + j * NW) * 16 + gi;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int b = 2 * ti + u;
        if (b < B) {
          part[b * NC + col] = cp[j][u];
          part[b * NC + col + 8] = cp[j][2 + u];
        }
      }
    }
  }
  FD_STAMP(2);

  // the first cache tiles go in flight while the partials are reduced
  const int ntot = first[BP];
  const size_t srow = (size_t)B * nkv * HD;   // cache stride per position
  bf16* ring_a = reinterpret_cast<bf16*>(r0);
  auto slot_of = [&](int f) {
    int b = 0;
    while (first[b + 1] <= f) ++b;
    return b;
  };
  auto load_a = [&](int f) {
    const int b = slot_of(f), s0 = sa[b] + (f - first[b]) * TA;
    const int nv = min(TA, se[b] - s0);
    bf16* ks = ring_a + (size_t)(f % AS) * 2 * TA * RS;
    bf16* vs = ks + TA * RS;
    const size_t col = ((size_t)b * nkv + g) * HD;
    for (int i = tid; i < nv * (HD / 8); i += NT) {
      const int p = i / (HD / 8), j = (i % (HD / 8)) * 8;
      const size_t off = (size_t)(s0 + p) * srow + col + j;
      cp_async16(ks + p * RS + j, kc + off);
      cp_async16(vs + p * RS + j, vc + off);
    }
    if (tid < nv) cp_async4(posb + (f % AS) * TA + tid, pos + (size_t)(s0 + tid) * B + b);
  };
#pragma unroll
  for (int f = 0; f < AS - 1; ++f) {
    if (f < ntot) load_a(f);
    cp_async_commit();
  }

  // ClusterReduce: each rank sums its slice in rank order, then gathers
  {
    const int n = B * NC / C;
    cluster::sum(part, qkv, rank * n, (rank + 1) * n);
    cluster::gather(qkv, n);
  }
  FD_STAMP(3);

  // ---- phase 3: the bias, then RoPE (rotate halves) on q and k, in f32 -
  if (bqkv != nullptr) {
    for (int i = tid; i < B * NC; i += NT) {
      const int b = i / NC, c = i % NC;
      const int col = c < H * HD ? qb * HD + c
                    : (c < (H + 1) * HD ? (nq + g) * HD + c - H * HD
                                        : (nq + nkv + g) * HD + c - (H + 1) * HD);
      qkv[b * NC + c] += bf2f(bqkv[col]);
    }
    __syncthreads();
  }
  constexpr int HALF = HD / 2;
  for (int idx = tid; idx < B * HALF; idx += NT) {
    const int b = idx / HALF, i = idx % HALF;
    const float c = cosv[b * HALF + i], s = sinv[b * HALF + i];
#pragma unroll
    for (int h = 0; h <= H; ++h) {   // the H query heads, then k
      float* r = qkv + b * NC + h * HD;
      const float r1 = r[i], r2 = r[i + HALF];
      r[i] = r1 * c - r2 * s;
      r[i + HALF] = r2 * c + r1 * s;
    }
  }
  for (int i = tid; i < R * HD; i += NT) aacc[i] = 0.f;
  if (tid < R) { am[tid] = -1e30f; al[tid] = 0.f; }
  __syncthreads();
  if (rank == 0 && qb % (nq / nkv) == 0) {   // the kv head's first cluster
    for (int idx = tid; idx < B * HD; idx += NT) {
      const int b = idx / HD, d = idx % HD;
      k_new[((size_t)b * nkv + g) * HD + d] = f2bf(qkv[b * NC + H * HD + d]);
      v_new[((size_t)b * nkv + g) * HD + d] = f2bf(qkv[b * NC + (H + 1) * HD + d]);
    }
  }

  // ---- phase 4: online softmax over this rank's share of each slot ----
  // warp-split: warp w scores keys KW·w .. KW·w + KW − 1 of a tile (LK
  // lanes a key: KW = 16 at hd 64, 8 at hd 128, 4 at hd 256) for the H
  // heads and keeps
  // its own running m, l and acc per head (its lane's VL = hd / 32
  // columns), so a tile needs no barrier of its own; at a slot's last
  // tile the eight warps' partials merge in warp order
  constexpr int LK = LPK<HD>, KW = 32 / LK, VL = HD / 32;
  static_assert(TA == KW * NW && HD == LK * 32 &&
                (VL == 2 || VL == 4 || VL == 8), "warp-split geometry");
  float* wpart = reinterpret_cast<float*>(smem + L.xs());   // [NW][H][4 + HD]
  // hd 256: this lane's q columns of the slot's H heads in registers,
  // loaded when the slot changes (its loop was issue-bound on the
  // shared-memory reads of q: 20 % of the phase, PERF.md §6); hd 128
  // reads q from shared memory
  constexpr int NU = HD / (8 * LK);
  float qv[HD == 256 ? H : 1][NU][8];
  int qslot = -1;
  float wm[H], wl[H], wacc[H][VL];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    wm[h] = -1e30f;
    wl[h] = 0.f;
#pragma unroll
    for (int u = 0; u < VL; ++u) wacc[h][u] = 0.f;
  }
  for (int f = 0; f < ntot; ++f) {
    cp_async_wait<AS - 2>();
    __syncthreads();
    if (f + AS - 1 < ntot) load_a(f + AS - 1);
    cp_async_commit();
    const int b = slot_of(f), t = f - first[b];
    const int s0 = sa[b] + t * TA, nv = min(TA, se[b] - s0);
    const int cl = clen[b];
    const bf16* ks = ring_a + (size_t)(f % AS) * 2 * TA * RS;
    const bf16* vs = ks + TA * RS;
    // scores: LK lanes a cache row, each K element read once for the H
    // heads
    const int p = tid / LK, l4 = tid % LK;
    if constexpr (HD == 256) {
      if (b != qslot) {
        qslot = b;
#pragma unroll
        for (int h = 0; h < H; ++h)
#pragma unroll
          for (int u = 0; u < NU; ++u)
#pragma unroll
            for (int k = 0; k < 8; ++k)
              qv[h][u][k] = qkv[b * NC + h * HD + l4 * 8 + 8 * LK * u + k];
      }
    }
    bool valid = false;
    float d[H];
#pragma unroll
    for (int h = 0; h < H; ++h) d[h] = 0.f;
    if (p < nv) {
      const int ps_ = posb[(f % AS) * TA + p];
      valid = ps_ >= 0 && ps_ < cl && (window <= 0 || ps_ > cl - window);
      const float* qr = qkv + b * NC;
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        const int j = l4 * 8 + 8 * LK * u;
        float k8[8];
        smem_bf16x8(ks + p * RS + j, k8);
#pragma unroll
        for (int h = 0; h < H; ++h) {
          if constexpr (HD == 256) {
            const float* q8 = qv[h][u];
            d[h] += q8[0] * k8[0] + q8[1] * k8[1] + q8[2] * k8[2] + q8[3] * k8[3]
                  + q8[4] * k8[4] + q8[5] * k8[5] + q8[6] * k8[6] + q8[7] * k8[7];
          } else {
            const float4 qa = *reinterpret_cast<const float4*>(qr + h * HD + j);
            const float4 qb4 = *reinterpret_cast<const float4*>(qr + h * HD + j + 4);
            d[h] += qa.x * k8[0] + qa.y * k8[1] + qa.z * k8[2] + qa.w * k8[3]
                  + qb4.x * k8[4] + qb4.y * k8[5] + qb4.z * k8[6] + qb4.w * k8[7];
          }
        }
      }
    }
    // the warp's online softmax over its KW keys, per head
    float pv[H];
#pragma unroll
    for (int h = 0; h < H; ++h) {
      float dh = d[h];
#pragma unroll
      for (int u = 1; u < LK; u <<= 1) dh += __shfl_xor_sync(0xffffffffu, dh, u);
      const float sv = valid ? softcap(dh * scale, cap) : -INFINITY;
      float mx = sv;
#pragma unroll
      for (int u = LK; u < 32; u <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, u));
      const float m_new = fmaxf(wm[h], mx), c = expf(wm[h] - m_new);
      pv[h] = valid ? expf(sv - m_new) : 0.f;
      float sum = pv[h];
#pragma unroll
      for (int u = LK; u < 32; u <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, u);
      wl[h] = wl[h] * c + sum;
      wm[h] = m_new;
#pragma unroll
      for (int u = 0; u < VL; ++u) wacc[h][u] *= c;
    }
    // p·v, p in f32: key kk's p from lane LK·kk; lane owns columns
    // VL·lane .. VL·lane + VL − 1
#pragma unroll
    for (int kk = 0; kk < KW; ++kk) {
      const int row = warp * KW + kk;
      if (row >= nv) break;
      float vv[VL];
      if constexpr (VL == 2) {
        const uint32_t u2 = lds32(vs + row * RS + lane * 2);
        vv[0] = lo_bf(u2);
        vv[1] = hi_bf(u2);
      } else if constexpr (VL == 4) {
        load_bf16x4_smem(vs + row * RS + lane * 4, vv);
      } else {
        smem_bf16x8(vs + row * RS + lane * 8, vv);
      }
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const float pk = __shfl_sync(0xffffffffu, pv[h], kk * LK);
#pragma unroll
        for (int u = 0; u < VL; ++u) wacc[h][u] += pk * vv[u];
      }
    }
    if (t == first[b + 1] - first[b] - 1) {   // the slot's last tile
#pragma unroll
      for (int h = 0; h < H; ++h) {
        float* wp = wpart + (warp * H + h) * (4 + HD);
        if (lane == 0) { wp[0] = wm[h]; wp[1] = wl[h]; }
        if constexpr (VL == 2) {
          *reinterpret_cast<float2*>(wp + 4 + lane * 2) =
              make_float2(wacc[h][0], wacc[h][1]);
        } else {
#pragma unroll
          for (int u = 0; u < VL; u += 4)
            *reinterpret_cast<float4*>(wp + 4 + lane * VL + u) =
                make_float4(wacc[h][u], wacc[h][u + 1], wacc[h][u + 2],
                            wacc[h][u + 3]);
        }
        wm[h] = -1e30f;
        wl[h] = 0.f;
#pragma unroll
        for (int u = 0; u < VL; ++u) wacc[h][u] = 0.f;
      }
      __syncthreads();
      for (int e = tid; e < H * HD; e += NT) {
        const int h = e / HD, dd = e % HD;
        float m = -1e30f, l = 0.f, a_ = 0.f;
        for (int w = 0; w < NW; ++w) {
          const float* pw = wpart + (w * H + h) * (4 + HD);
          const float mw = pw[0], mn = fmaxf(m, mw);
          const float ca = expf(m - mn), cb = expf(mw - mn);
          l = l * ca + pw[1] * cb;
          a_ = a_ * ca + pw[4 + dd] * cb;
          m = mn;
        }
        aacc[(b * H + h) * HD + dd] = a_;
        if (dd == 0) { am[b * H + h] = m; al[b * H + h] = l; }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  FD_STAMP(4);

  // the first wo tiles go in flight before the merge: the H heads' rows
  // of wo, head by head, TR rows a tile; with H > 1 rank r starts at head
  // r mod H and cluster ci at row tile ci mod TPH of each head, so the
  // clusters' and ranks' reads spread over the heads' rows instead of
  // moving through them in step.  A thread copies one 16-byte column
  // chunk of every rpp-th row of a tile (its offsets set once here).
  constexpr int TR = TRO<H>;
  constexpr int TPH = HD / TR;       // wo tiles a head
  constexpr int OS = OST<H>;
  auto head_of = [&](int t) { return H == 1 ? 0 : (t / TPH + rank) % H; };
  auto rows_of = [&](int t) { return H == 1 ? t % TPH : (t + ci) % TPH; };
  bf16* ring_o = reinterpret_cast<bf16*>(r0);
  const int cpr = Dr / 8, rpp = NT / cpr;      // chunks a row, rows a pass
  const int oj = (tid % cpr) * 8, op0 = tid / cpr;
  auto load_o = [&](int t) {
    bf16* dst = ring_o + (size_t)(t % OS) * TR * xrow + oj;
    const bf16* src = wo + (size_t)(qb + head_of(t)) * HD * D
                    + (size_t)rows_of(t) * TR * D + d0 + oj;
    if (op0 < rpp)
      for (int p = op0; p < TR; p += rpp)
        cp_async16(dst + p * xrow, src + (size_t)p * D);
  };
#pragma unroll
  for (int t = 0; t < OS - 1; ++t) {
    if (t < H * TPH) load_o(t);
    cp_async_commit();
  }

  // ---- phase 5: (m, l, acc) merged over the cluster, in rank order ----
  // H = 1: every rank merges every row (cluster::flash_merge) into acc2.
  // H > 1 (R = B·H rows): a reduce-scatter, then a gather — every rank
  // merges the m and l of every row and keeps each rank's factors (ca,
  // cb) of the flash-merge operator; then its slice of the rows' acc with
  // those factors (the operator's own arithmetic, in rank order) into
  // accm; then the ranks gather accm
  float* accm = reinterpret_cast<float*>(smem + L.xs());   // [R][HD]
  if constexpr (H == 1) {
    cluster::flash_merge(am, R, HD, 0, R * HD,
                         [&](int e, float m, float l, float4 a) {
      const int r = e / HD, d = e % HD;
      *reinterpret_cast<float4*>(acc2 + r * AC + d) = a;
      if (d == 0) { mfin[r] = m; lfin[r] = l; }
    });
  } else {
    cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
    float* fac = acc2;                 // [R][C][2], until phase 6
    cl.sync();
    if (tid < R) {
      float mc[MAX_C], lc[MAX_C];
#pragma unroll
      for (int c = 0; c < MAX_C; ++c) {
        if (c < C) {
          const float* p = cl.map_shared_rank(am, c);
          mc[c] = p[tid];
          lc[c] = p[R + tid];
        }
      }
      float m = -1e30f, l = 0.f;
#pragma unroll
      for (int c = 0; c < MAX_C; ++c) {
        if (c < C) {
          const float m_new = fmaxf(m, mc[c]);
          const float ca = expf(m - m_new), cb = expf(mc[c] - m_new);
          l = l * ca + lc[c] * cb;
          m = m_new;
          fac[(tid * C + c) * 2] = ca;
          fac[(tid * C + c) * 2 + 1] = cb;
        }
      }
      mfin[tid] = m;
      lfin[tid] = l;
    }
    __syncthreads();
    const int n = R * HD / C;          // this rank's slice of acc
    for (int i = 4 * tid; i < n; i += 4 * NT) {
      const int e = rank * n + i, r = e / HD;
      float4 xc[MAX_C];
#pragma unroll
      for (int c = 0; c < MAX_C; ++c)
        if (c < C)
          xc[c] = *reinterpret_cast<const float4*>(
              cl.map_shared_rank(aacc, c) + e);
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int c = 0; c < MAX_C; ++c) {
        if (c < C) {
          const float ca = fac[(r * C + c) * 2], cb = fac[(r * C + c) * 2 + 1];
          a.x = a.x * ca + xc[c].x * cb;
          a.y = a.y * ca + xc[c].y * cb;
          a.z = a.z * ca + xc[c].z * cb;
          a.w = a.w * ca + xc[c].w * cb;
        }
      }
      *reinterpret_cast<float4*>(accm + e) = a;
    }
    cluster::gather(accm, n);          // its first sync: every slice read
  }
  __syncthreads();

  FD_STAMP(5);

  // ---- phase 6: the new token (f32 k/v), gated by include_new --------
  for (int r = warp; r < R; r += NW) {
    const int b = r / H, h = r % H;
    float dot = 0.f;
    for (int d = lane; d < HD; d += 32)
      dot += qkv[b * NC + h * HD + d] * qkv[b * NC + H * HD + d];
    dot = warp_sum(dot);
    if (lane == 0) {
      const float s_new = include_new[b] > 0 ? softcap(dot * scale, cap) : -1e30f;
      const float m_fin = fmaxf(mfin[r], s_new);
      const float p = expf(s_new - m_fin);
      const float c = expf(mfin[r] - m_fin);
      const float l_fin = lfin[r] * c + p;
      cn[r] = c;
      pn[r] = p;
      if (rank == 0) {
        m_out[(size_t)b * nq + qb + h] = m_fin;
        l_out[(size_t)b * nq + qb + h] = l_fin;
      }
    }
  }
  __syncthreads();
  const float* am2 = H == 1 ? acc2 : accm;   // the merged acc
  const int ams = H == 1 ? AC : HD;
  for (int idx = tid; idx < BP * H * HD; idx += NT) {
    const int r = idx / HD, d = idx % HD;
    acc2[r * AC + d] = r < R ? am2[r * ams + d] * cn[r]
                                + pn[r] * qkv[(r / H) * NC + (H + 1) * HD + d]
                              : 0.f;
  }

  FD_STAMP(6);

  // ---- phase 7: o[b, qb + h, d0 + :Dr] = acc[b, h] · wo[qb + h][:, d0 + :Dr]
  // one head after the other, acc as bf16 hi + lo terms.  H = 1: warp w
  // owns columns [w·Dr/8, (w+1)·Dr/8) as Dr/64 n tiles, A = acc (rows
  // 8-15 zero).  H > 1: the wo tile is A (m tiles of 16 columns w, w + 8,
  // …, ldmatrix .trans of its [k][m] rows) and acc is B (the slots on n),
  // so no MMA row is padding: half the products
  if constexpr (H == 1) {
    const int nto = Dr / 64;
    constexpr int NTO = MAX_NTO<H>;
    float co[NTO][4];
#pragma unroll
    for (int n = 0; n < NTO; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) co[n][j] = 0.f;
    for (int t = 0; t < H * TPH; ++t) {
      cp_async_wait<OS - 2>();
      __syncthreads();
      if (t + OS - 1 < H * TPH) load_o(t + OS - 1);
      cp_async_commit();
      const int h = head_of(t), tt = rows_of(t);
      const bf16* tile = ring_o + (size_t)(t % OS) * TR * xrow;
      const float* ar = acc2 + (gi * H + h) * AC + tt * TR + ti * 2;
      uint32_t ahi[4] = {0u, 0u, 0u, 0u}, alo[4] = {0u, 0u, 0u, 0u};
      split_bf16(*reinterpret_cast<const float2*>(ar), ahi[0], alo[0]);
      split_bf16(*reinterpret_cast<const float2*>(ar + 8), ahi[2], alo[2]);
      const bf16* tb = tile + ((lane & 7) + (mi & 1) * 8) * xrow
                     + warp * (Dr / NW) + (mi >> 1) * 8;
#pragma unroll
      for (int n = 0; n < NTO; n += 2) {
        if (n < nto) {
          uint32_t bq[4];
          ldsm_x4_t(tb + n * 8, bq);
          mma_bf16(co[n], ahi, bq[0], bq[1]);
          mma_bf16(co[n], alo, bq[0], bq[1]);
          mma_bf16(co[n + 1], ahi, bq[2], bq[3]);
          mma_bf16(co[n + 1], alo, bq[2], bq[3]);
        }
      }
      if (t % TPH == TPH - 1) {       // head h done: its slice of o
        if (gi < B) {
          float* orow = o + ((size_t)gi * nq + qb + h) * D + d0
                      + warp * (Dr / NW) + ti * 2;
#pragma unroll
          for (int n = 0; n < NTO; ++n)
            if (n < nto)
              *reinterpret_cast<float2*>(orow + n * 8) = make_float2(co[n][0], co[n][1]);
        }
#pragma unroll
        for (int n = 0; n < NTO; ++n)
#pragma unroll
          for (int j = 0; j < 4; ++j) co[n][j] = 0.f;
      }
    }
  } else {
    constexpr int MAX_MT = MAX_NTO<H> / 2;   // m tiles a warp: 64·MAX_NTO rows
    const int nmt = Dr / 16;
    // ldmatrix .trans of the [k][m] tile: lanes 0-7 rows k 0-7 at m 0,
    // 8-15 rows k 0-7 at m 8, 16-23 rows k 8-15 at m 0, 24-31 rows k 8-15
    // at m 8 (a0 a1 a2 a3 of m16n8k16)
    const int ak = (lane & 7) + ((lane >> 4) << 3), amo = ((lane >> 3) & 1) << 3;
    float cm[MAX_MT][4];
#pragma unroll
    for (int j = 0; j < MAX_MT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) cm[j][q] = 0.f;
    for (int t = 0; t < H * TPH; ++t) {
      cp_async_wait<OS - 2>();
      __syncthreads();
      if (t + OS - 1 < H * TPH) load_o(t + OS - 1);
      cp_async_commit();
      const int h = head_of(t), tt = rows_of(t);
      const bf16* tile = ring_o + (size_t)(t % OS) * TR * xrow;
#pragma unroll
      for (int ks = 0; ks < TR / 16; ++ks) {   // the tile's k16 steps
        const float* br = acc2 + (gi * H + h) * AC + tt * TR + ks * 16 + ti * 2;
        uint32_t bhi0, blo0, bhi1, blo1;
        split_bf16(*reinterpret_cast<const float2*>(br), bhi0, blo0);
        split_bf16(*reinterpret_cast<const float2*>(br + 8), bhi1, blo1);
#pragma unroll
        for (int j = 0; j < MAX_MT; ++j) {
          const int mt = warp + j * NW;
          if (mt < nmt) {
            uint32_t af[4];
            ldsm_x4_t(tile + (ks * 16 + ak) * xrow + mt * 16 + amo, af);
            mma_bf16(cm[j], af, bhi0, bhi1);
            mma_bf16(cm[j], af, blo0, blo1);
          }
        }
      }
      if (t % TPH == TPH - 1) {       // head h done: its slice of o
        // c0 c1: column gi of the m tile, slots 2·ti and 2·ti + 1; c2 c3:
        // column gi + 8
#pragma unroll
        for (int j = 0; j < MAX_MT; ++j) {
          const int mt = warp + j * NW;
          if (mt < nmt) {
            const int col = d0 + mt * 16 + gi;
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int b = 2 * ti + u;
              if (b < B) {
                float* ob = o + ((size_t)b * nq + qb + h) * D + col;
                ob[0] = cm[j][u];
                ob[8] = cm[j][2 + u];
              }
            }
          }
        }
#pragma unroll
        for (int j = 0; j < MAX_MT; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) cm[j][q] = 0.f;
      }
    }
  }
  cp_async_wait<0>();
  FD_STAMP(7);
}

// Rows a rank may hold: a multiple of 64 (eight warps' n tiles of wo) up
// to 64·MAX_NTO (1152 for two heads a cluster, 1024 for the others).
template <int H>
bool rows_ok(int Dr) { return Dr >= 64 && Dr <= 64 * MAX_NTO<H> && Dr % 64 == 0; }

template <int B, int H, int HD>
size_t smem_bytes(int D, int C) { return Lay<B, H, HD>{D / C}.total(); }

template <int B, int H, int HD>
int launch(int C, const bf16* x, const bf16* wqkv, const bf16* wo,
           const float* ln1, const bf16* kc, const bf16* vc, const int* pos,
           const int* cache_lens, const int* include_new, const float* cosv,
           const float* sinv, const bf16* bqkv, float* o, bf16* k_new,
           bf16* v_new, float* m, float* l, int D, int S, int nq, int nkv,
           int window, int pos_base, float scale, float eps, float cap,
           cudaStream_t stream) {
  return (int)cluster::launch(
      fused_decode_kernel<B, H, HD>, dim3(nq / H * C), NT,
      smem_bytes<B, H, HD>(D, C), stream, C, x, wqkv, wo, ln1, kc, vc, pos,
      cache_lens, include_new, cosv, sinv, bqkv, o, k_new, v_new, m, l, D,
      S, nq, nkv, window, pos_base, scale, eps, cap);
}

template <int H, int HD>
int launch_b(int B, int C, const bf16* x, const bf16* wqkv, const bf16* wo,
             const float* ln1, const bf16* kc, const bf16* vc, const int* pos,
             const int* cache_lens, const int* include_new, const float* cosv,
             const float* sinv, const bf16* bqkv, float* o, bf16* k_new,
             bf16* v_new, float* m, float* l, int D, int S, int nq, int nkv,
             int window, int pos_base, float scale, float eps, float cap,
             cudaStream_t stream) {
#define ARGS C, x, wqkv, wo, ln1, kc, vc, pos, cache_lens, include_new, cosv, \
    sinv, bqkv, o, k_new, v_new, m, l, D, S, nq, nkv, window, pos_base, scale, \
    eps, cap, stream
  switch (B) {
    case 1: return launch<1, H, HD>(ARGS);
    case 2: return launch<2, H, HD>(ARGS);
    case 3: return launch<3, H, HD>(ARGS);
    case 4: return launch<4, H, HD>(ARGS);
    case 5: return launch<5, H, HD>(ARGS);
    case 6: return launch<6, H, HD>(ARGS);
    case 7: return launch<7, H, HD>(ARGS);
    case 8: return launch<8, H, HD>(ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ARGS
}

// The shared memory a CTA may use (227 KB on an H100).
constexpr size_t SMEM_MAX = 232448;

// The instances: (H, hd) = (q_per_kv, 128) for q_per_kv 1-4, (2, 128)
// for q_per_kv 8 (Qwen2-72B: four clusters of two query heads a kv head),
// (2, 256) for q_per_kv 16 (RecurrentGemma-9B: 8 clusters of two query
// heads) and for 8 and 4 (a rank of RecurrentGemma-9B on a mesh at
// heads_sub 2 and 4: 4 and 2 such clusters), and (1, 64) for MHA
// (SeamlessM4T-medium: a cluster a head)
bool instance_ok(int qpk, int hd, int H) {
  if (hd == 128) return (H == qpk && H >= 1 && H <= 4) || (qpk == 8 && H == 2);
  if (hd == 64) return qpk == 1 && H == 1;
  return hd == 256 && (qpk == 16 || qpk == 8 || qpk == 4) && H == 2;
}

// The plan the kernel takes: C ranks (a power of two up to 8) that split
// d_model into rows_ok runs, H query heads a cluster of an instance,
// within the shared memory a CTA has.
bool plan_ok(int nq, int nkv, int hd, int D, int C, int H) {
  if (!(nkv >= 1 && nq % nkv == 0 && instance_ok(nq / nkv, hd, H) &&
        C >= 1 && C <= MAX_C && D % C == 0 &&
        (H == 2 ? rows_ok<2>(D / C) : rows_ok<1>(D / C))))
    return false;
  const size_t smem = hd == 256 ? smem_bytes<BP, 2, 256>(D, C)
                    : hd == 64 ? smem_bytes<BP, 1, 64>(D, C)
                    : H == 1 ? smem_bytes<BP, 1, 128>(D, C)
                    : H == 2 ? smem_bytes<BP, 2, 128>(D, C)
                    : H == 3 ? smem_bytes<BP, 3, 128>(D, C)
                             : smem_bytes<BP, 4, 128>(D, C);
  return smem <= SMEM_MAX;
}

}  // namespace

extern "C" int fused_decode_launch(
    const void* x, const void* wqkv, const void* wo, const void* ln1,
    const void* kc, const void* vc, const void* pos, const void* cache_lens,
    const void* include_new, const void* cosv, const void* sinv,
    const void* bqkv, void* o, void* k_new, void* v_new, void* m, void* l,
    int B, int D, int S, int nq,
    int nkv, int hd, int C, int H, int window, int pos_base, float scale,
    float eps, float cap, void* stream) {
  if (!plan_ok(nq, nkv, hd, D, C, H) || pos_base < -1)
    return (int)cudaErrorInvalidValue;
#define ARGS B, C, (const bf16*)x, (const bf16*)wqkv, (const bf16*)wo,           \
    (const float*)ln1, (const bf16*)kc, (const bf16*)vc, (const int*)pos,        \
    (const int*)cache_lens, (const int*)include_new, (const float*)cosv,         \
    (const float*)sinv, (const bf16*)bqkv, (float*)o, (bf16*)k_new,              \
    (bf16*)v_new, (float*)m, (float*)l, D, S, nq, nkv, window, pos_base, scale,  \
    eps, cap, (cudaStream_t)stream
  if (hd == 256) return launch_b<2, 256>(ARGS);
  if (hd == 64) return launch_b<1, 64>(ARGS);
  switch (H) {
    case 1: return launch_b<1, 128>(ARGS);
    case 2: return launch_b<2, 128>(ARGS);
    case 3: return launch_b<3, 128>(ARGS);
    case 4: return launch_b<4, 128>(ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ARGS
}
