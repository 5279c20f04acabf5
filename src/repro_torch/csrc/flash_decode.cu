// B5 — flash decode: GQA attention of q against a KV cache clamped by a
// length, with the optional attention softcap and sliding window; q in,
// the normalized output out.  One C entry, one device launch.
//
// Replaces repro/kernels/flash_decode/flash_decode.py:flash_decode_attention
// (the Pallas kernel at its pallas_call, line 100), the paper's unfused
// baseline: projections, RoPE and the output projection run as separate
// products around it.  Two forms share the kernel:
//   * the Pallas signature: q [B, q_loc, hd] against ONE cache
//     [S, kv_loc, hd] of length cache_len (all B slots share it: G = 1
//     group of NB = B slots);
//   * the engine's per-slot form, jax.vmap of the Pallas kernel over
//     slots: cache [S, B, kv_loc, hd], lengths [B] (G = B groups of NB = 1
//     slot, slot b attends only to its own cache column and length).
// Row s is valid iff s < L and, with a window, s > L - window (by index,
// as the Pallas kernel masks).  Scores, m, l and the accumulator are f32,
// and p stays f32 for p·v (flash_decode.py:44-64); m starts at -1e30 and
// l is clamped to 1e-30, so a length-0 slot returns zeros, not NaN.
//
// The rank-local mode (a cluster across devices: one rank's shard of the
// KV sequence, its partial merged with the other ranks' afterwards, as
// the reference's bucketed_flash_attention feeds cluster_flash_combine,
// core/dataflow.py:264 and :557) takes the per-slot form with the
// stored positions pos [S, B] and each slot's cache_len: L is then the
// rank-local span the wrapper computes, no row is culled by its offset
// (on a ring shard offsets are not positions), and row s is valid iff
// 0 <= pos <= cache_len and, with a window, pos > cache_len - window; a
// row masked so scores -inf, so its p is 0 whatever the running max.
// Its output is the unnormalized f32 acc with m and l, for the combine.
// The mode is a template parameter (POS): the one-device instances are
// the kernel as it was, and the rank-local instances are bf16 at head dim
// 128, the caches of every attention decoder the port shards, and at
// head dim 256 only the three query-row counts RecurrentGemma-9B's ring
// shards take (launch_pos256; every instance of every head dim would
// add a third to the build time).
//
// Bound on an H100: bytes.  Each valid K and V row is read once for all
// nq = NB·qpk query rows of its (group, kv head), at 4·nq FLOPs per
// 2·hd·2 bytes — under the ~295 FLOP/byte ridge even at nq = 32.  Design:
//   * one thread-block cluster of C CTAs per kv head and block of GB
//     consecutive groups (the wrapper's plan, from S, G, kv and nq only:
//     RecurrentGemma's 16 query rows on a 2048-row ring, GB = 1 and
//     C = 8; Llama2-7B's per-slot decode, GB = 4 slots of one head and
//     C = 4).  Each group's live span is cut into C runs of equal
//     length, rank r streaming run r of every group in tiles of up to TR
//     rows: the ranks of a cluster get the same bytes however ragged the
//     lengths, and a group's split, so its bits, depend on its own span
//     alone; a rank with no valid row holds (-1e30, 0, 0);
//   * each rank streams its tiles of K and V through a cp.async ring, so
//     the next tiles' loads are in flight while one is computed;
//   * three ways through a tile, by the group's query rows nq and the
//     dtype: bf16 with nq >= 16 (RecurrentGemma: 16 query heads on one kv
//     head) runs QKᵀ on the tensor cores, mma.sync m16n8k16 with bf16 in
//     and f32 accumulation (exact products summed in f32), and p·v there
//     too with p split into bf16 hi + lo terms (two mma.sync each, v
//     through ldmatrix.trans: p kept to ~2^-17, never rounded to bf16);
//     bf16 with nq <= 4 (Llama: 1) is warp-split on the CUDA cores, each
//     warp scoring 8 keys of the tile and keeping its own running m, l
//     and acc, merged in warp order at a group's end, with no barrier
//     inside a tile; everything else (5-15 rows, f32) scores on the CUDA
//     cores with four lanes a (row, key) pair and a block-wide softmax,
//     each thread one column of v and RPT query rows of p·v in f32;
//   * the C partials (m, l, acc) of the GB·nq rows merge over DSMEM in
//     rank order (cluster::flash_merge), each rank merging and writing
//     its slice of o in q's dtype: no workspace, no second launch, no
//     float atomics, and the same result run to run.
#include "cluster.cuh"

namespace {

constexpr int NT = 256;     // threads a CTA
constexpr int NW = NT / 32;
constexpr int MAXQ = 32;    // query rows a cluster: GB·nq
constexpr int KV_TILE_BYTES = 32768;   // K (or V) bytes of a tile, at most
constexpr int CC_TILE_ROWS = 64;       // rows of a tile on the CUDA cores
// K and V bytes of the ring, at most
constexpr int RING_BYTES = 65536;
constexpr int MMA_RING_BYTES = 131072;

DEVI float to_f(float v) { return v; }
DEVI float to_f(bf16 v) { return bf2f(v); }
template <typename T> DEVI T from_f(float v);
template <> DEVI float from_f<float>(float v) { return v; }
template <> DEVI bf16 from_f<bf16>(float v) { return f2bf(v); }

// 8 consecutive elements from a 16-byte aligned shared-memory address.
DEVI void smem8(const bf16* p, float out[8]) { smem_bf16x8(p, out); }
DEVI void smem8(const float* p, float out[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

constexpr size_t smax_(size_t a, size_t b) { return a > b ? a : b; }

// Geometry of kernel <T, HD, RPT, MT, WS>: tiles of TR rows (64, or
// fewer when a row is wider than 512 bytes) in a ring of STAGES (2 to
// 4); rows padded by 16 bytes so 16-byte reads (and ldmatrix) of
// consecutive rows fall on distinct banks; MAXQ query rows held, QT of
// them (one group's) scored a tile (or, warp-split, each warp's partial
// over WS rows); the partial m, l, acc of MAXQ rows.
template <typename T, int HD, int RPT, int MT, int WS, bool POS>
struct Geo {
  static constexpr int ROWB = HD * (int)sizeof(T);
  static constexpr int TR_ = MT > 0 ? 64 : CC_TILE_ROWS;
  static constexpr int TR = KV_TILE_BYTES / ROWB < TR_ ? KV_TILE_BYTES / ROWB : TR_;
  static constexpr int STAGES_ =
      (MT > 0 ? MMA_RING_BYTES : RING_BYTES) / (2 * TR * ROWB);
  static constexpr int STAGES = STAGES_ < 2 ? 2 : (STAGES_ > 4 ? 4 : STAGES_);
  static constexpr int RS = HD + 16 / (int)sizeof(T);
  static constexpr int VEC = 16 / (int)sizeof(T);   // elements a cp.async
  static constexpr int VR = HD / VEC;               // cp.asyncs a row
  static constexpr int QT = MT > 0 ? 16 * MT : RPT * (NT / HD);
  static constexpr int PSR = TR + 4;                // scores row stride
  static constexpr size_t ring = (size_t)STAGES * 2 * TR * RS * sizeof(T);
  // the rest, for R query rows a cluster: the query rows T [R + 16][RS]
  // (zero past R: the MMA's m tiles read up to 16 past a group's first
  // row); the scores f32 [QT][PSR], or warp-split, the warps' partials
  // [NW][2·WS + WS·HD]; the rank's partial m, l, acc; corr [MAXQ]; the
  // tile table (ints)
  struct Lay { size_t qs, ps, part, corr, tab, total; };
  __host__ __device__ static constexpr Lay lay(int R) {
    const size_t qs = ring;
    const size_t ps = qs + (size_t)(R + 16) * RS * sizeof(T);
    const size_t part = ps + smax_((size_t)QT * PSR * 4,
                                   (size_t)NW * (2 * WS + WS * HD) * 4);
    const size_t corr = part + (size_t)(cluster::acc_offset(R) + R * HD) * 4;
    const size_t tab = corr + (size_t)MAXQ * 4;
    return {qs, ps, part, corr, tab,
            tab + (size_t)((POS ? 4 : 3) * MAXQ + 4) * 4};
  }
};

// Query row r of group g under kv head h: slot g·NB + r / qpk, query head
// h·qpk + r % qpk of q [B, kv·qpk, HD].
DEVI size_t q_off(int g, int r, int h, int NB, int kv, int qpk, int HD) {
  const int b = g * NB + r / qpk, hq = h * qpk + r % qpk;
  return ((size_t)b * kv * qpk + hq) * HD;
}

// A score as the Pallas kernel forms it: scaled, optionally softcapped,
// -1e30 for a row past the tile's valid ones.
DEVI float finish_score(float d, bool valid, float scale, float cap,
                         bool live = true) {
  if (!valid) return -1e30f;
  if (!live) return -INFINITY;      // masked by its stored pos
  float s = d * scale;
  if (cap > 0.f) s = tanhf(s / cap) * cap;
  return s;
}

// Rank `rank` of the cluster of (groups [g0, g0 + GB), kv head h).  MT > 0:
// bf16 with 16·(MT−1) < nq ≤ 16·MT, QKᵀ and p·v on the tensor cores;
// WS > 0: bf16 with nq ≤ WS, warp-split on the CUDA cores (each warp 8
// keys of a tile with its own running m, l, acc, merged at a group's
// end: no barrier inside a tile); else the CUDA cores, RPT query rows a
// thread in p·v.
template <typename T, int HD, int RPT, int MT, int WS, bool POS>
__global__ void __launch_bounds__(NT)
flash_cluster_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ lens,
                     T* __restrict__ o, int G, int GB, int NB, int S, int kv,
                     int qpk, float scale, float cap, int window,
                     const int* __restrict__ pos, const int* __restrict__ clens,
                     float* __restrict__ of, float* __restrict__ m_out,
                     float* __restrict__ l_out) {
  using Q = Geo<T, HD, RPT, MT, WS, POS>;
  constexpr int TR = Q::TR, RS = Q::RS, PSR = Q::PSR, NRG = NT / HD;
  static_assert(MT == 0 || sizeof(T) == 2, "tensor cores: bf16 only");
  // warp-split: KPW keys a warp, LPK lanes a key
  constexpr int KPW = TR / NW, LPK = 32 / KPW;
  static_assert(WS == 0 || (TR % NW == 0 && 32 % KPW == 0 && HD % (8 * LPK) == 0),
                "warp-split: whole keys a warp");
  // clusters in launch order walk the group blocks fastest, so the long
  // spans of a batch are spread over the whole launch
  const int rank = blockIdx.x, C = gridDim.x, nblk = G / GB;
  const int g0 = (blockIdx.y % nblk) * GB, h = blockIdx.y / nblk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gi = lane >> 2, ti = lane & 3;          // mma fragment indices
  const int nq = NB * qpk, R = GB * nq;             // rows: this cluster's
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const auto Lz = Q::lay(R);
  T* qs = reinterpret_cast<T*>(smem + Lz.qs);
  float* ps = reinterpret_cast<float*>(smem + Lz.ps);
  float* wpart = ps;                                // warp-split only
  float* m_run = reinterpret_cast<float*>(smem + Lz.part);   // the partial
  float* l_run = m_run + R;
  float* pacc = m_run + cluster::acc_offset(R);
  float* corr = reinterpret_cast<float*>(smem + Lz.corr);
  int* sa = reinterpret_cast<int*>(smem + Lz.tab);   // [GB]: run in group j
  int* se = sa + MAXQ;
  int* first = se + MAXQ;                            // [GB + 1] tile prefix
  int* gcl = first + MAXQ + 4;                       // [GB] cache_len (POS)

  // the lengths, then the query rows (zero past R), go in flight first
  if (tid < GB) {
    first[tid] = lens[g0 + tid];
    if constexpr (POS) gcl[tid] = clens[g0 + tid];
  }
  for (int i = tid; i < (R + 16) * Q::VR; i += NT) {
    const int r = i / Q::VR, j = (i % Q::VR) * Q::VEC;
    const bool live = r < R;
    const size_t src = live ? q_off(g0 + r / nq, r % nq, h, NB, kv, qpk, HD) : 0;
    cp_async16_zfill(qs + r * RS + j, q + src + j, live ? 16 : 0);
  }
  // this rank's share: each group's live span cut into C runs of equal
  // length, rank r taking run r, in tiles of up to TR rows — a group's
  // split depends on its own span alone, so its bits do not depend on
  // the other groups (what a recovery replay needs)
  __syncthreads();
  if (tid == 0) {
    int f = 0;
    for (int j = 0; j < GB; ++j) {
      int L = first[j];
      L = L < 0 ? 0 : (L < S ? L : S);
      const int lo = window > 0 && !POS ? max(0, L - window + 1) : 0;
      const int n = L - lo, per = (n + C - 1) / C;
      sa[j] = lo + min(n, rank * per);
      se[j] = lo + min(n, rank * per + per);
      first[j] = f;
      f += (se[j] - sa[j] + TR - 1) / TR;
    }
    first[GB] = f;
  }
  for (int i = tid; i < Q::QT * PSR; i += NT) ps[i] = 0.f;  // padded rows stay 0
  for (int i = tid; i < R * HD; i += NT) pacc[i] = 0.f;
  if (tid < R) { m_run[tid] = -1e30f; l_run[tid] = 0.f; }
  if (tid < MAXQ) corr[tid] = 1.f;
  __syncthreads();

  // the rank-local mode's mask by stored pos: row p of tile t of group j
  auto live_row = [&](int j, int s0, int p) {
    if constexpr (!POS) {
      return true;
    } else {
      const int ps_ = pos[(size_t)(s0 + p) * G + g0 + j], cl = gcl[j];
      return ps_ >= 0 && ps_ <= cl && (window <= 0 || ps_ > cl - window);
    }
  };
  // rows past a tile's valid ones are zero-filled: the tensor cores
  // multiply them by p = 0, which must not meet a NaN
  const size_t srow = (size_t)G * kv * HD;            // cache row stride
  const int nt = first[GB];
  auto group_of = [&](int t) {
    int j = 0;
    while (first[j + 1] <= t) ++j;
    return j;
  };
  // a thread copies one 16-byte column chunk of rows p0, p0 + PSTEP, ...
  constexpr int PSTEP = NT / Q::VR;
  const int p0 = tid / Q::VR, j0 = (tid % Q::VR) * Q::VEC;
  auto load_tile = [&](int t) {
    const int j = group_of(t), s0 = sa[j] + (t - first[j]) * TR;
    const int nv = min(TR, se[j] - s0);
    T* ks = ring + (size_t)(t % Q::STAGES) * 2 * TR * RS + p0 * RS + j0;
    T* vs = ks + TR * RS;
    const size_t off = (size_t)s0 * srow + ((size_t)(g0 + j) * kv + h) * HD + j0;
#pragma unroll
    for (int p = p0; p < TR; p += PSTEP) {
      const size_t o_ = off + (size_t)min(p, nv - 1) * srow;
      const int bytes = p < nv ? 16 : 0;
      cp_async16_zfill(ks + (p - p0) * RS, k + o_, bytes);
      cp_async16_zfill(vs + (p - p0) * RS, v + o_, bytes);
    }
  };
#pragma unroll
  for (int t = 0; t < Q::STAGES - 1; ++t) {
    if (t < nt) load_tile(t);
    cp_async_commit();     // the first group also holds the query rows
  }

  // p·v accumulators of the current group: CUDA cores, column `col` of
  // rows rg + NRG·i; tensor cores, the C fragments of MT m tiles × NTN n
  // tiles of the warp's columns.  Flushed to pacc at the group's last tile.
  constexpr int NTN = MT > 0 ? HD / (8 * NW) : 1;
  const int col = tid % HD, rg = tid / HD;
  float acc[MT > 0 || RPT == 0 ? 1 : RPT];
  float cfr[MT > 0 ? MT : 1][NTN][4];
#pragma unroll
  for (int i = 0; i < (MT > 0 || RPT == 0 ? 1 : RPT); ++i) acc[i] = 0.f;
#pragma unroll
  for (int mt = 0; mt < (MT > 0 ? MT : 1); ++mt)
#pragma unroll
    for (int n = 0; n < NTN; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) cfr[mt][n][j] = 0.f;

  // warp-split: the warp's running m, l and its lane's HD/32 columns of
  // acc, for each of the group's rows
  constexpr int CPL = HD / 32, WR = WS > 0 ? WS : 1;
  float wm[WR], wl[WR], wacc[WR][CPL];
#pragma unroll
  for (int r = 0; r < WR; ++r) {
    wm[r] = -1e30f;
    wl[r] = 0.f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) wacc[r][c] = 0.f;
  }

  for (int t = 0; t < nt; ++t) {
    // tile t has landed; past this barrier no thread still reads the
    // stage that tile t + STAGES − 1 overwrites (tile t − 1's)
    cp_async_wait<Q::STAGES - 2>();
    __syncthreads();
    if (t + Q::STAGES - 1 < nt) load_tile(t + Q::STAGES - 1);
    cp_async_commit();
    const int j = group_of(t), t_in = t - first[j];
    const int s0 = sa[j] + t_in * TR;
    const int nv = min(TR, se[j] - s0);
    const int rb = j * nq;                 // the group's first row
    const T* ks = ring + (size_t)(t % Q::STAGES) * 2 * TR * RS;
    const T* vs = ks + TR * RS;
    const T* qg = qs + rb * RS;
    const bool last = t == first[j + 1] - 1;   // the group's last tile here

    if constexpr (WS > 0) {
      // warp w: keys KPW·w .. KPW·w + KPW − 1 of the tile, LPK lanes a key
      const int sub = lane % LPK, key = warp * KPW + lane / LPK;
      const bool kval = key < nv;
      float s_[WR];
#pragma unroll
      for (int r = 0; r < WR; ++r) {
        float d = 0.f;
        if (r < nq && kval) {
          const T* kr = ks + key * RS;
          const T* qr = qg + r * RS;
#pragma unroll
          for (int jj = sub * 8; jj < HD; jj += 8 * LPK) {
            float k8[8], q8[8];
            smem8(kr + jj, k8);
            smem8(qr + jj, q8);
#pragma unroll
            for (int u = 0; u < 8; ++u) d += q8[u] * k8[u];
          }
        }
#pragma unroll
        for (int u = 1; u < LPK; u <<= 1) d += __shfl_xor_sync(0xffffffffu, d, u);
        s_[r] = finish_score(d, kval, scale, cap, kval && live_row(j, s0, key));
      }
      // the warp's online softmax over its KPW keys (lanes of one sub)
#pragma unroll
      for (int r = 0; r < WR; ++r) {
        if (r >= nq) break;
        float mx = s_[r];
#pragma unroll
        for (int u = LPK; u < 32; u <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, u));
        const float m_new = fmaxf(wm[r], mx), c = expf(wm[r] - m_new);
        const float pr = kval ? expf(s_[r] - m_new) : 0.f;
        float sum = pr;
#pragma unroll
        for (int u = LPK; u < 32; u <<= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, u);
        wl[r] = wl[r] * c + sum;
        wm[r] = m_new;
        s_[r] = pr;
#pragma unroll
        for (int cc = 0; cc < CPL; ++cc) wacc[r][cc] *= c;
      }
      // p·v, p in f32: key kk's p from lane LPK·kk
#pragma unroll
      for (int kk = 0; kk < KPW; ++kk) {
        const int row = warp * KPW + kk;
        if (row >= nv) break;
        float vv[CPL];
#pragma unroll
        for (int cc = 0; cc < CPL; ++cc) vv[cc] = to_f(vs[row * RS + lane * CPL + cc]);
#pragma unroll
        for (int r = 0; r < WR; ++r) {
          const float pk = __shfl_sync(0xffffffffu, s_[r], kk * LPK);
          if (r < nq) {
#pragma unroll
            for (int cc = 0; cc < CPL; ++cc) wacc[r][cc] += pk * vv[cc];
          }
        }
      }
      if (last) {
        // the eight warps' partials merge in warp order into the group's
        // rows of the rank's partial
        float* wp = wpart + warp * (2 * WR + WR * HD);
#pragma unroll
        for (int r = 0; r < WR; ++r) {
          if (r < nq) {
            if (lane == 0) { wp[r] = wm[r]; wp[WR + r] = wl[r]; }
#pragma unroll
            for (int cc = 0; cc < CPL; ++cc)
              wp[2 * WR + r * HD + lane * CPL + cc] = wacc[r][cc];
          }
          wm[r] = -1e30f;
          wl[r] = 0.f;
#pragma unroll
          for (int cc = 0; cc < CPL; ++cc) wacc[r][cc] = 0.f;
        }
        __syncthreads();
        const float* w0 = wpart;
        for (int e = tid; e < nq * HD; e += NT) {
          const int r = e / HD, d = e % HD;
          float m = -1e30f, l = 0.f, a = 0.f;
          for (int w = 0; w < NW; ++w) {
            const float* pw = w0 + w * (2 * WR + WR * HD);
            const float mw = pw[r], m_new = fmaxf(m, mw);
            const float ca = expf(m - m_new), cb = expf(mw - m_new);
            l = l * ca + pw[WR + r] * cb;
            a = a * ca + pw[2 * WR + r * HD + d] * cb;
            m = m_new;
          }
          pacc[(rb + r) * HD + d] = a;
          if (d == 0) { m_run[rb + r] = m; l_run[rb + r] = l; }
        }
      }
      continue;
    }

    // scores ps[r][p] of the group's rows r < nq
    if constexpr (MT > 0) {
      // one 8-row n tile of the cache a warp at a time, every m tile
      for (int n8 = warp; n8 < TR / 8; n8 += NW) {
        const bf16* kr = ks + (n8 * 8 + gi) * RS + ti * 2;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          // two independent accumulation chains over hd, summed after
          float c[4] = {0.f, 0.f, 0.f, 0.f}, c2[4] = {0.f, 0.f, 0.f, 0.f};
          const bf16* q0 = qg + (mt * 16 + gi) * RS + ti * 2;
          const bf16* q1 = q0 + 8 * RS;
#pragma unroll 4
          for (int k0 = 0; k0 < HD; k0 += 32) {
            const uint32_t af[4] = {lds32(q0 + k0), lds32(q1 + k0),
                                    lds32(q0 + k0 + 8), lds32(q1 + k0 + 8)};
            mma_bf16(c, af, lds32(kr + k0), lds32(kr + k0 + 8));
            const uint32_t ag[4] = {lds32(q0 + k0 + 16), lds32(q1 + k0 + 16),
                                    lds32(q0 + k0 + 24), lds32(q1 + k0 + 24)};
            mma_bf16(c2, ag, lds32(kr + k0 + 16), lds32(kr + k0 + 24));
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) c[u] += c2[u];
          const int p = n8 * 8 + ti * 2, r0 = mt * 16 + gi, r1 = r0 + 8;
          if (r0 < nq)
            *reinterpret_cast<float2*>(ps + r0 * PSR + p) = make_float2(
                finish_score(c[0], p < nv, scale, cap, p < nv && live_row(j, s0, p)),
                finish_score(c[1], p + 1 < nv, scale, cap,
                             p + 1 < nv && live_row(j, s0, p + 1)));
          if (r1 < nq)
            *reinterpret_cast<float2*>(ps + r1 * PSR + p) = make_float2(
                finish_score(c[2], p < nv, scale, cap, p < nv && live_row(j, s0, p)),
                finish_score(c[3], p + 1 < nv, scale, cap,
                             p + 1 < nv && live_row(j, s0, p + 1)));
        }
      }
    } else {
      // four lanes a (query row, cache row) pair; nq·TR·4 is a multiple
      // of 128, so every warp that enters reaches the shuffles whole
      for (int i = tid; i < nq * TR * 4; i += NT) {
        const int l4 = i & 3, pair = i >> 2, r = pair / TR, p = pair % TR;
        float d = 0.f;
        if (p < nv) {
          const T* kr = ks + p * RS;
          const T* qr = qg + r * RS;
#pragma unroll 4
          for (int jj = l4 * 8; jj < HD; jj += 32) {
            float k8[8], q8[8];
            smem8(kr + jj, k8);
            smem8(qr + jj, q8);
#pragma unroll
            for (int u = 0; u < 8; ++u) d += q8[u] * k8[u];
          }
        }
        d += __shfl_xor_sync(0xffffffffu, d, 1);
        d += __shfl_xor_sync(0xffffffffu, d, 2);
        if (l4 == 0)
          ps[r * PSR + p] = finish_score(d, p < nv, scale, cap,
                                         p < nv && live_row(j, s0, p));
      }
    }
    __syncthreads();

    // online softmax statistics, half a warp a query row; p = 0 past nv
    {
      const int half = lane >> 4, l16 = lane & 15;
      for (int r2 = 2 * warp; r2 < nq; r2 += 2 * NW) {
        const int r = r2 + half;
        const bool live = r < nq;
        float* pr = ps + (live ? r : r2) * PSR;
        float mx = -1e30f;
        for (int p = l16; p < nv; p += 16) mx = fmaxf(mx, pr[p]);
#pragma unroll
        for (int u = 8; u > 0; u >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, u));
        const float m_old = m_run[rb + (live ? r : r2)], m_new = fmaxf(m_old, mx);
        float sum = 0.f;
        for (int p = l16; p < TR; p += 16) {
          const float x = p < nv ? expf(pr[p] - m_new) : 0.f;
          if (live) pr[p] = x;
          sum += x;
        }
#pragma unroll
        for (int u = 8; u > 0; u >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, u);
        if (live && l16 == 0) {
          const float c = expf(m_old - m_new);
          corr[r] = c;
          l_run[rb + r] = l_run[rb + r] * c + sum;
          m_run[rb + r] = m_new;
        }
      }
    }
    __syncthreads();

    if constexpr (MT > 0) {
      // p·v on the tensor cores: p as bf16 hi + lo, two mma.sync each
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float c0 = corr[mt * 16 + gi], c1 = corr[mt * 16 + gi + 8];
#pragma unroll
        for (int n = 0; n < NTN; ++n) {
          cfr[mt][n][0] *= c0; cfr[mt][n][1] *= c0;
          cfr[mt][n][2] *= c1; cfr[mt][n][3] *= c1;
        }
      }
      const int n0 = warp * (HD / NW), mi = lane >> 3;
#pragma unroll
      for (int k0 = 0; k0 < TR; k0 += 16) {
        uint32_t ahi[MT][4], alo[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const float* pa = ps + (mt * 16 + gi) * PSR + k0 + ti * 2;
          const float* pb = pa + 8 * PSR;
          split_bf16(*reinterpret_cast<const float2*>(pa), ahi[mt][0], alo[mt][0]);
          split_bf16(*reinterpret_cast<const float2*>(pb), ahi[mt][1], alo[mt][1]);
          split_bf16(*reinterpret_cast<const float2*>(pa + 8), ahi[mt][2], alo[mt][2]);
          split_bf16(*reinterpret_cast<const float2*>(pb + 8), ahi[mt][3], alo[mt][3]);
        }
        const bf16* vrow = reinterpret_cast<const bf16*>(vs)
                         + (k0 + (lane & 7) + (mi & 1) * 8) * RS + n0;
        if constexpr (NTN == 1) {
          uint32_t b[2];
          ldsm_x2_t(vrow, b);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(cfr[mt][0], ahi[mt], b[0], b[1]);
            mma_bf16(cfr[mt][0], alo[mt], b[0], b[1]);
          }
        } else {
#pragma unroll
          for (int n = 0; n < NTN; n += 2) {
            uint32_t b[4];
            ldsm_x4_t(vrow + n * 8 + (mi >> 1) * 8, b);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              mma_bf16(cfr[mt][n], ahi[mt], b[0], b[1]);
              mma_bf16(cfr[mt][n], alo[mt], b[0], b[1]);
              mma_bf16(cfr[mt][n + 1], ahi[mt], b[2], b[3]);
              mma_bf16(cfr[mt][n + 1], alo[mt], b[2], b[3]);
            }
          }
        }
      }
      if (last) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int n = 0; n < NTN; ++n) {
            const int c = n0 + n * 8 + ti * 2;
            const int r0 = mt * 16 + gi, r1 = r0 + 8;
            if (r0 < nq)
              *reinterpret_cast<float2*>(pacc + (rb + r0) * HD + c) =
                  make_float2(cfr[mt][n][0], cfr[mt][n][1]);
            if (r1 < nq)
              *reinterpret_cast<float2*>(pacc + (rb + r1) * HD + c) =
                  make_float2(cfr[mt][n][2], cfr[mt][n][3]);
#pragma unroll
            for (int u = 0; u < 4; ++u) cfr[mt][n][u] = 0.f;
          }
      }
    } else {
      // p·v on the CUDA cores, p in f32: one column a thread, rows rg,
      // rg + NRG, ...
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = rg + NRG * i;
        if (r < nq) acc[i] *= corr[r];
      }
      for (int p = 0; p < nv; ++p) {
        const float vv = to_f(vs[p * RS + col]);
#pragma unroll
        for (int i = 0; i < RPT; ++i)
          if (rg + NRG * i < nq) acc[i] += ps[(rg + NRG * i) * PSR + p] * vv;
      }
      if (last) {
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int r = rg + NRG * i;
          if (r < nq) pacc[(rb + r) * HD + col] = acc[i];
          acc[i] = 0.f;
        }
      }
    }
  }
  cp_async_wait<0>();

  // the partial m[R], l[R], acc[R][HD], merged over the cluster in rank
  // order, each rank writing its slice of o
  const int E = R * HD, slice = (E + C - 1) / C;
  const int begin = min(E, rank * slice), end = min(E, begin + slice);
  cluster::flash_merge(m_run, R, HD, begin, end,
                       [&](int el, float m, float l, float4 x) {
    const int row = el / HD, d = el % HD;
    const size_t qo = q_off(g0 + row / nq, row % nq, h, NB, kv, qpk, HD);
    if constexpr (POS) {               // the rank-local partial, unnormalized
      *reinterpret_cast<float4*>(of + qo + d) = x;
      if (d == 0) { m_out[qo / HD] = m; l_out[qo / HD] = l; }
      return;
    }
    const float lc = fmaxf(l, 1e-30f);
    T* od = o + qo + d;
    od[0] = from_f<T>(x.x / lc);
    od[1] = from_f<T>(x.y / lc);
    od[2] = from_f<T>(x.z / lc);
    od[3] = from_f<T>(x.w / lc);
  });
}

template <typename T, int HD, int RPT, int MT, int WS, bool POS>
int launch(const void* q, const void* k, const void* v, const void* lens,
           void* o, int G, int GB, int NB, int S, int kv, int qpk, int C,
           float scale, float cap, int window, const int* pos,
           const int* clens, float* of, float* m, float* l, cudaStream_t st) {
  return (int)cluster::launch(
      flash_cluster_kernel<T, HD, RPT, MT, WS, POS>, dim3(C, kv * (G / GB)), NT,
      Geo<T, HD, RPT, MT, WS, POS>::lay(GB * NB * qpk).total, st, C, (const T*)q,
      (const T*)k,
      (const T*)v, (const int*)lens, (T*)o, G, GB, NB, S, kv, qpk, scale,
      cap, window, pos, clens, of, m, l);
}

// The instance for nq query rows: bf16 from 16 rows up on the tensor
// cores (one or two 16-row m tiles), bf16 up to 4 rows warp-split, else
// the smallest register bucket of rows a thread.
template <typename T, int HD, bool POS>
int launch_hd(int nq, const void* q, const void* k, const void* v,
              const void* lens, void* o, int G, int GB, int NB, int S, int kv,
              int qpk, int C, float scale, float cap, int window,
              const int* pos, const int* clens, float* of, float* m, float* l,
              cudaStream_t st) {
  constexpr int NRG = NT / HD;
  const int need = (nq + NRG - 1) / NRG;
#define ARGS q, k, v, lens, o, G, GB, NB, S, kv, qpk, C, scale, cap, window, \
    pos, clens, of, m, l, st
  if constexpr (sizeof(T) == 2) {
    if (nq > 16) return launch<T, HD, 0, 2, 0, POS>(ARGS);
    if (nq == 16) return launch<T, HD, 0, 1, 0, POS>(ARGS);
    if (nq == 1) return launch<T, HD, 0, 0, 1, POS>(ARGS);
    if (nq <= 4) return launch<T, HD, 0, 0, 4, POS>(ARGS);
  }
  if (need <= 1) return launch<T, HD, 1, 0, 0, POS>(ARGS);
  if (need <= 4) return launch<T, HD, 4, 0, 0, POS>(ARGS);
  if (need <= 8) return launch<T, HD, 8, 0, 0, POS>(ARGS);
  if constexpr (HD >= 128) {
    if (need <= 16) return launch<T, HD, 16, 0, 0, POS>(ARGS);
  }
  if constexpr (HD == 256) return launch<T, HD, 32, 0, 0, POS>(ARGS);
#undef ARGS
  return (int)cudaErrorInvalidValue;
}

// The rank-local instances at head dim 256: RecurrentGemma-9B's local
// layers on a ring shard, with the query heads a rank holds at the serve
// layouts that take a cluster across devices (16 at heads_sub 1, 8 and 4
// at 2 and 4, one kv head): the tensor-core, register-bucket and
// warp-split ways of launch_hd, each at its one row count.
int launch_pos256(int nq, const void* q, const void* k, const void* v,
                  const void* lens, void* o, int G, int GB, int NB, int S,
                  int kv, int qpk, int C, float scale, float cap, int window,
                  const int* pos, const int* clens, float* of, float* m,
                  float* l, cudaStream_t st) {
#define ARGS q, k, v, lens, o, G, GB, NB, S, kv, qpk, C, scale, cap, window, \
    pos, clens, of, m, l, st
  if (nq == 16) return launch<bf16, 256, 0, 1, 0, true>(ARGS);
  if (nq == 8) return launch<bf16, 256, 8, 0, 0, true>(ARGS);
  if (nq == 4) return launch<bf16, 256, 0, 0, 4, true>(ARGS);
#undef ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const void* lens, void* o,
                                   int G, int GB, int NB, int S, int kv,
                                   int qpk, int hd, int is_f32, int C,
                                   float scale, float cap, int window,
                                   const void* pos, const void* clens,
                                   void* of, void* m, void* l, void* stream) {
  const int nq = NB * qpk;
  if (G < 1 || GB < 1 || G % GB || NB < 1 || S < 1 || kv < 1 || qpk < 1 ||
      GB * nq > MAXQ || (long long)kv * (G / GB) > 65535 ||
      // the rank-local mode (bf16, head dim 128 or 256): the per-slot
      // form, pos and cache_len with the partial's three outputs, or none
      (pos != nullptr && (NB != 1 || is_f32 || (hd != 128 && hd != 256) ||
                          clens == nullptr ||
                          of == nullptr || m == nullptr || l == nullptr)) ||
      (pos == nullptr && (of != nullptr || m != nullptr || l != nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define ARGS nq, q, k, v, lens, o, G, GB, NB, S, kv, qpk, C, scale, cap, window, \
    (const int*)pos, (const int*)clens, (float*)of, (float*)m, (float*)l, st
  switch (hd * 2 + (is_f32 ? 1 : 0)) {
    case 64 * 2: return launch_hd<bf16, 64, false>(ARGS);
    case 128 * 2: return pos ? launch_hd<bf16, 128, true>(ARGS)
                             : launch_hd<bf16, 128, false>(ARGS);
    case 256 * 2: return pos ? launch_pos256(ARGS)
                             : launch_hd<bf16, 256, false>(ARGS);
    case 64 * 2 + 1: return launch_hd<float, 64, false>(ARGS);
    case 128 * 2 + 1: return launch_hd<float, 128, false>(ARGS);
    case 256 * 2 + 1: return launch_hd<float, 256, false>(ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ARGS
}
