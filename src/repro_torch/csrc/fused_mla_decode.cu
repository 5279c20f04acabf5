// B4 — fused MLA decode with weight absorption (paper Alg. 4): RMSNorm +
// Q-Projection + KV down-projection + K-up absorption + RoPE + ragged flash
// decode in latent space + the folded value-up/Output-Projection
// ("partial_o" through wproj = W_UV·W_O), for all B slots, in two device
// launches.
//
// Replaces repro/kernels/fused_mla_decode/fused_mla_decode.py:
// fused_mla_decode_attention (the Pallas kernel at its pallas_call, line
// 261) in the serving mode of core/dataflow.py:_mla_attention_pallas_packed:
// fuse_out="partial_o", fused ln1, linear latent cache with per-slot pos,
// include_new from the append rule, pos_base ≥ 0 (the shard's first
// position on a cluster across devices: r·S on rank r); MLA's geometry of nope
// 128, rope 64 and a 512-wide latent (DeepSeek-V2/V3).
//
// Bound on an H100: bytes.  At DeepSeek-V2-Lite widths a layer reads wq
// (12.6 MB), wdkv (2.4 MB), wuk (2.1 MB) and wproj (33.6 MB, 61 % of the
// layer's bytes) once for all slots, plus each slot's live latent rows
// (1152 bytes a position), at a few FLOPs per byte.  Design, the paper's
// Alg. 4 on clusters of C = 8 CTAs:
//   launch 1 (mla_ckv_kernel, 9 clusters) computes the new latent entry
//     c_new = [c_lat | RoPE(c_rope)] of rms(x)·wdkv once for all heads,
//     each cluster 64 columns, rounded to the cache dtype (every head
//     attends that rounded entry);
//   launch 2 (fused_mla_decode_kernel) runs one cluster per head (16
//     clusters, 128 CTAs at DeepSeek-V2-Lite).  Rank r of the cluster of
//     head h
//   1. normalizes its rows [r·D/8, (r+1)·D/8) of x for all slots (the
//      rows' sums of squares summed over the cluster in rank order) and
//      keeps them rounded to bf16 as the Pallas kernel's fuse_norm branch
//      (line 69);
//   2. streams those rows of head h's 192 wq columns ONCE through a
//      6-stage cp.async ring and multiplies them on the tensor cores
//      (mma.sync m16n8k16, the B ≤ 8 normed rows as A);
//   3. ClusterReduce: the [B, 192] f32 partials are summed in rank order
//      (cluster::sum) and gathered (cluster::gather), so every rank holds
//      the same q_h; RoPE in f32 on q_rope;
//   4. q_lat = q_nope·wuk[h] for its 64 of the 512 latent columns (f32 on
//      the CUDA cores: q stays f32), gathered over the cluster;
//   5. flash decode over its share of all slots' live latent rows laid end
//      to end (C runs of equal length, in 32-row tiles that stop at a
//      slot's edge; a 2-stage cp.async ring), the scores and p·C on the
//      tensor cores (f32 q and p as bf16 hi + lo terms), each warp its 64
//      latent columns and a rope k step, the warps' partial scores summed
//      in warp order; every warp keeps the same online softmax (m from
//      -1e30) and its own 64 columns of acc, so no per-warp partial needs
//      merging;
//   6. ClusterReduce with the flash-merge operator: the ranks' (m, l,
//      acc[512]) merge in rank order over DSMEM (cluster::flash_merge);
//      the new token is folded in with the ROUNDED c_new (the Pallas
//      kernel's line 146), gated by include_new; rank 0 writes m and l;
//   7. o[b, h, r·D/8 + :D/8] = acc · wproj[h][:, r·D/8 + :D/8] on the
//      tensor cores (an 8-stage ring), acc split into bf16 hi + lo terms;
//      unnormalized f32.
// No f32 workspace: partials are combined on chip in a fixed order, with
// no float atomics.  The live latent rows are read by every cluster (16×
// from L2, once from HBM).
#include "cluster.cuh"

namespace {

constexpr int NT = 256;          // 8 warps
constexpr int NW = NT / 32;
constexpr int CL = 8;            // CTAs a cluster: the latent columns a
                                 // rank's q_lat block holds are a warp's
constexpr int BP = 8;            // slots as laid out
constexpr int NOPE = 128, ROPE = 64, LAT = 512;
constexpr int LR = LAT + ROPE;   // a latent cache row
constexpr int HR = NOPE + ROPE;  // a head's q columns
constexpr int NQC = HR;          // projected columns a rank: q_h
constexpr int PROW = NQC + 8;    // padded projection tile row (bf16)
constexpr int NTW = NQC / 8 / NW; // 8-column n tiles a warp (3)
constexpr int CQ = 64;           // launch 1: wdkv columns a cluster
constexpr int WROW = CQ + 8;     // launch 1: padded wdkv tile row (bf16)
constexpr int TK = 16;           // weight rows a tile: one k16 step
constexpr int PST = 6;           // projection ring stages
constexpr int QB = LAT / CL;     // q_lat columns a rank (64)
constexpr int TRA = 32;          // latent rows a tile: two m tiles
constexpr int AROW = LR + 8;     // padded latent row (bf16)
constexpr int AST = 2;           // latent ring stages
constexpr int OST = 8;           // wproj ring stages
constexpr int OPRE = 6;          // wproj tiles that load during the merge
constexpr int ACS = LAT + 4;     // merged acc row stride (f32)
constexpr int MAX_NTO = 8;       // wproj n tiles a warp: D / 8 ≤ 512
constexpr int NKO = LAT / TK;    // wproj tiles
static_assert(QB == 64 && LAT == 64 * NW && ROPE % 16 == 0 && ROPE / 16 <= NW,
              "a warp's columns: 64 latent, and 16 rope on the first warps");

__host__ __device__ constexpr size_t smax(size_t a, size_t b) {
  return a > b ? a : b;
}

// Shared-memory layout for Dr = D / 8 rows a rank.
struct Lay {
  int Dr;
  __host__ __device__ int xrow() const { return Dr + 8; }   // bf16, padded
  // the rank's attention partial m[BP], l[BP], acc[BP][LAT]
  __host__ __device__ size_t apart_bytes() const {
    return (size_t)(cluster::acc_offset(BP) + BP * LAT) * 4;
  }
  __host__ __device__ size_t o_stage() const { return (size_t)TK * xrow() * 2; }
  // region 0, reused phase by phase: the projection ring; its partial and
  // the reduced q_h (f32 [BP][NQC] each); the latent ring; the wproj ring,
  // with the attention partial over its last stages (the first OPRE load
  // during the merge).  From pre() on, until the latent ring: ln1's rows
  // [Dr] and RoPE's cos and sin [BP][ROPE / 2] each
  __host__ __device__ size_t pre() const {
    return smax((size_t)PST * TK * PROW * 2, (size_t)2 * BP * NQC * 4);
  }
  __host__ __device__ size_t r0() const {
    size_t s = pre() + (size_t)(Dr + BP * ROPE) * 4;
    s = smax(s, (size_t)AST * TRA * AROW * 2);
    s = smax(s, OST * o_stage());
    return smax(s, OPRE * o_stage() + apart_bytes());
  }
  __host__ __device__ size_t apart() const { return r0() - apart_bytes(); }
  // q_lat blocks f32 [CL][BP][QB] (first wuk[h]'s rank columns, bf16
  // [NOPE][QB]; last the merged acc f32 [BP][ACS]), then q_rope f32
  // [BP][ROPE]
  __host__ __device__ size_t qf() const { return r0(); }
  __host__ __device__ size_t qr() const { return qf() + (size_t)CL * BP * QB * 4; }
  // the normed rows bf16 [BP][xrow], then c_new bf16 [BP][LR]
  __host__ __device__ size_t cn() const { return qr() + (size_t)BP * ROPE * 4; }
  __host__ __device__ size_t misc() const {
    return cn() + smax((size_t)BP * xrow() * 2, (size_t)BP * LR * 2);
  }
  // misc: red_ss [NW·BP]; ssp ssa inv snew mfin lfin cnf pnf rm rl [BP];
  //       sc [NW][TRA]; ints clen sa se [BP], first [BP + 4], pos tiles
  //       [AST][TRA]
  __host__ __device__ size_t total() const {
    return misc() + (size_t)(NW * BP + 10 * BP + NW * TRA) * 4
         + (size_t)(4 * BP + 4 + AST * TRA) * 4;
  }
};
static_assert(CL * BP * QB * 4 >= BP * ACS * 4 - BP * ROPE * 4 &&
              CL * BP * QB * 4 >= NOPE * QB * 2, "qf region holds wuk, acc");

template <int B>
__global__ void __launch_bounds__(NT, 2)
fused_mla_decode_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ wq,
    const bf16* __restrict__ wuk, const bf16* __restrict__ wproj,
    const float* __restrict__ ln1, const bf16* __restrict__ cache,
    const int* __restrict__ pos, const int* __restrict__ cache_lens,
    const int* __restrict__ include_new, const float* __restrict__ cosv,
    const float* __restrict__ sinv, float* __restrict__ o,
    const bf16* __restrict__ c_new, float* __restrict__ m_out,
    float* __restrict__ l_out, int D, int S, int nq, int pos_base, float scale,
    float eps) {
  const int rank = blockIdx.x % CL, h = blockIdx.x / CL;
  const Lay L{D / CL};
  const int Dr = L.Dr, d0 = rank * Dr, xrow = L.xrow();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gi = lane >> 2, ti = lane & 3, mi = lane >> 3;   // fragments
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* r0 = smem;
  float* part = reinterpret_cast<float*>(r0);
  float* qc = part + BP * NQC;
  float* apart = reinterpret_cast<float*>(r0 + L.apart());
  float* qf = reinterpret_cast<float*>(smem + L.qf());
  bf16* wuk_s = reinterpret_cast<bf16*>(smem + L.qf());
  float* acc2 = qf;
  float* qr = reinterpret_cast<float*>(smem + L.qr());
  bf16* xs = reinterpret_cast<bf16*>(smem + L.cn());
  bf16* cn_s = xs;
  float* ln1s = reinterpret_cast<float*>(r0 + L.pre());
  float* cos_s = ln1s + Dr;          // [BP][ROPE / 2]
  float* sin_s = cos_s + BP * (ROPE / 2);
  float* red_ss = reinterpret_cast<float*>(smem + L.misc());
  float* ssp = red_ss + NW * BP;
  float* ssa = ssp + BP;
  float* inv = ssa + BP;
  float* snew = inv + BP;
  float* mfin = snew + BP;
  float* lfin = mfin + BP;
  float* cnf = lfin + BP;
  float* pnf = cnf + BP;
  float* rm = pnf + BP;              // a slot's m and l on this rank
  float* rl = rm + BP;
  float* sc = rl + BP;               // [NW][TRA]
  int* clen = reinterpret_cast<int*>(sc + NW * TRA);
  int* sa = clen + BP;
  int* se = sa + BP;
  int* first = se + BP;              // [BP + 1] prefix of tiles by slot
  int* posb = first + BP + 4;        // [AST][TRA]

  // ---- prologue: this thread's 8-column groups of x (registers); ln1's
  // rows, RoPE's cos and sin and the cache lengths, wuk[h]'s rank
  // columns, then the first projection tiles (a commit group each)
  constexpr int MAXP = BP * (64 * MAX_NTO) / 8 / NT;   // pairs a thread
  const int gr = Dr / 8, npair = B * gr;
  uint4 xu[MAXP];
#pragma unroll
  for (int k = 0; k < MAXP; ++k) {
    const int p = tid + k * NT;
    if (p < npair)
      xu[k] = __ldg(reinterpret_cast<const uint4*>(
          x + (size_t)(p / gr) * D + d0 + (p % gr) * 8));
  }
  constexpr int HALF = ROPE / 2;
  for (int i = tid; i < Dr / 4; i += NT) cp_async16(ln1s + i * 4, ln1 + d0 + i * 4);
  if (tid < BP) {
    if (tid < B) cp_async4(clen + tid, cache_lens + tid);
    else clen[tid] = 0;
  }
  for (int i = tid; i < 2 * B * HALF / 4; i += NT) {
    const int k = i % (B * HALF / 4);
    cp_async16((i < B * HALF / 4 ? cos_s : sin_s) + k * 4,
               (i < B * HALF / 4 ? cosv : sinv) + k * 4);
  }
  cp_async_commit();
  for (int i = tid; i < NOPE * (QB / 8); i += NT) {
    const int n = i / (QB / 8), j = (i % (QB / 8)) * 8;
    cp_async16(wuk_s + n * QB + j,
               wuk + ((size_t)h * NOPE + n) * LAT + rank * QB + j);
  }
  cp_async_commit();
  const int np = Dr / TK;                   // projection tiles
  const int PQ = nq * HR;
  bf16* ring_p = reinterpret_cast<bf16*>(r0);
  // q_h: wq columns [h·HR, (h+1)·HR)
  auto load_p = [&](int t) {
    bf16* dst = ring_p + (size_t)(t % PST) * TK * PROW;
    const bf16* src = wq + (size_t)(d0 + t * TK) * PQ + h * HR;
    for (int i = tid; i < TK * (NQC / 8); i += NT) {
      const int p = i / (NQC / 8), j = (i % (NQC / 8)) * 8;
      cp_async16(dst + p * PROW + j, src + (size_t)p * PQ + j);
    }
  };
#pragma unroll
  for (int t = 0; t < PST - 1; ++t) {
    if (t < np) load_p(t);
    cp_async_commit();
  }

  // ---- phase 1: RMSNorm(x, ln1) of this rank's rows (the sums of
  // squares summed over the cluster in rank order), rounded to bf16 ----
  {
    float ss[B];
#pragma unroll
    for (int b = 0; b < B; ++b) ss[b] = 0.f;
#pragma unroll
    for (int k = 0; k < MAXP; ++k) {
      const int p = tid + k * NT;
      if (p >= npair) break;
      const uint4 u = xu[k];
      const float v8[8] = {lo_bf(u.x), hi_bf(u.x), lo_bf(u.y), hi_bf(u.y),
                           lo_bf(u.z), hi_bf(u.z), lo_bf(u.w), hi_bf(u.w)};
      float sq = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) sq += v8[e] * v8[e];
#pragma unroll
      for (int bb = 0; bb < B; ++bb)
        if (bb == p / gr) ss[bb] += sq;
      *reinterpret_cast<uint4*>(xs + (p / gr) * xrow + (p % gr) * 8) = u;
    }
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const float s = warp_sum(ss[b]);
      if (lane == 0) red_ss[warp * BP + b] = s;
    }
    __syncthreads();
    if (tid < BP) {
      float s = 0.f;
      if (tid < B)
        for (int w = 0; w < NW; ++w) s += red_ss[w * BP + tid];
      ssp[tid] = s;
    }
    cluster::sum(ssp, ssa, 0, BP);
    if (tid < B) inv[tid] = 1.0f / sqrtf(ssa[tid] / (float)D + eps);
    cp_async_wait<PST>();           // ln1's rows, cos, sin, lengths landed
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
#pragma unroll
      for (int k = 0; k < 8; ++k)
        xr[k] = f2bf(v8[k] * inv[b] * (1.0f + ln1s[c + k]));
    }
  }

  // this rank's share of the live rows: each slot's rows [0, L_b) cut
  // into CL runs of equal length, rank r taking run r, in tiles of TRA
  // rows — a slot's split depends on its own length alone, so its bits
  // do not depend on the other slots (what a recovery replay needs).
  // L_b counts from the shard's first position pos_base: a slot whose
  // positions all lie before this shard reads nothing here
  if (tid == 0) {
    int f = 0;
    for (int b = 0; b < BP; ++b) {
      const int cl = clen[b] - pos_base;
      const int L = cl < 0 ? 0 : (cl < S ? cl : S);
      const int per = (L + CL - 1) / CL;
      sa[b] = min(L, rank * per);
      se[b] = min(L, sa[b] + per);
      first[b] = f;
      f += (se[b] - sa[b] + TRA - 1) / TRA;
    }
    first[BP] = f;
  }

  // ---- phase 2: rows [d0, d0 + Dr) of q_h --------------------------
  // warp w: columns [24w, 24w + 24) as three n tiles; A = the normed rows
  // (rows 8-15 of the m16 tile are zero: B ≤ 8)
  float cw[NTW][4];
#pragma unroll
  for (int n = 0; n < NTW; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) cw[n][j] = 0.f;
  for (int t = 0; t < np; ++t) {
    // tile t has landed, and no thread still reads the stage that tile
    // t + PST - 1 overwrites
    cp_async_wait<PST - 2>();
    __syncthreads();
    if (t + PST - 1 < np) load_p(t + PST - 1);
    cp_async_commit();
    const bf16* tile = ring_p + (size_t)(t % PST) * TK * PROW;
    const bf16* xa = xs + gi * xrow + t * TK + ti * 2;
    const uint32_t af[4] = {lds32(xa), 0u, lds32(xa + 8), 0u};
    const bf16* tb = tile + ((lane & 7) + (mi & 1) * 8) * PROW
                   + warp * NTW * 8 + (mi >> 1) * 8;
#pragma unroll
    for (int n = 0; n + 1 < NTW; n += 2) {
      uint32_t bq[4];
      ldsm_x4_t(tb + n * 8, bq);
      mma_bf16(cw[n], af, bq[0], bq[1]);
      mma_bf16(cw[n + 1], af, bq[2], bq[3]);
    }
    if (NTW & 1) {         // the last n tile: rows k 0-7 and 8-15
      uint32_t bq[2];
      ldsm_x2_t(tile + ((lane & 7) + (mi & 1) * 8) * PROW + warp * NTW * 8
                    + (NTW - 1) * 8, bq);
      mma_bf16(cw[NTW - 1], af, bq[0], bq[1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // this rank's [B][NQC] partial (slots past B dropped), over the ring
  if (gi < B) {
#pragma unroll
    for (int n = 0; n < NTW; ++n) {
      float* pr = part + gi * NQC + (warp * NTW + n) * 8 + ti * 2;
      *reinterpret_cast<float2*>(pr) = make_float2(cw[n][0], cw[n][1]);
    }
  }
  // ClusterReduce: each rank sums its slice in rank order, then gathers
  {
    const int n = B * NQC / CL;
    cluster::sum(part, qc, rank * n, (rank + 1) * n);
    cluster::gather(qc, n);
  }

  // ---- phase 3: RoPE on q_rope, launch 1's c_new, this rank's q_lat
  // columns
  for (int i = tid; i < B * LR / 8; i += NT)
    reinterpret_cast<uint4*>(cn_s)[i] = __ldg(reinterpret_cast<const uint4*>(c_new) + i);
  for (int idx = tid; idx < BP * HALF; idx += NT) {
    const int b = idx / HALF, i = idx % HALF;
    float q1 = 0.f, q2 = 0.f;
    if (b < B) {
      const float c = cos_s[b * HALF + i], s = sin_s[b * HALF + i];
      const float t1 = qc[b * NQC + NOPE + i], t2 = qc[b * NQC + NOPE + HALF + i];
      q1 = t1 * c - t2 * s;
      q2 = t2 * c + t1 * s;
    }
    qr[b * ROPE + i] = q1;
    qr[b * ROPE + HALF + i] = q2;
  }
  // q_lat[b, rank·64 + j] = Σ_n q_nope[b, n]·wuk[h, n, rank·64 + j] in
  // f32: thread (two columns j, j + 1; slot b = warp), four n a step
  float ql[2] = {0.f, 0.f};
  const int qj = 2 * lane;
  if (warp < B) {
    const float* qn = qc + warp * NQC;
#pragma unroll 4
    for (int n = 0; n < NOPE; n += 4) {
      const float4 q4 = *reinterpret_cast<const float4*>(qn + n);
      const float qv[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t w2 = lds32(wuk_s + (n + k) * QB + qj);
        ql[0] += qv[k] * lo_bf(w2);
        ql[1] += qv[k] * hi_bf(w2);
      }
    }
  }
  __syncthreads();          // wuk_s and qc read: both regions are free

  // the first latent tiles go in flight while q_lat is gathered
  const int ntot = first[BP];
  bf16* ring_a = reinterpret_cast<bf16*>(r0);
  auto slot_of = [&](int f) {
    int b = 0;
    while (first[b + 1] <= f) ++b;
    return b;
  };
  auto load_a = [&](int f) {
    const int b = slot_of(f), s0 = sa[b] + (f - first[b]) * TRA;
    const int nv = min(TRA, se[b] - s0);
    bf16* cs = ring_a + (size_t)(f % AST) * TRA * AROW;
    // rows past nv are zero-filled: the products take every row of a tile
    for (int i = tid; i < TRA * (LR / 8); i += NT) {
      const int p = i / (LR / 8), j = (i % (LR / 8)) * 8;
      if (p < nv)
        cp_async16(cs + p * AROW + j, cache + ((size_t)(s0 + p) * B + b) * LR + j);
      else
        cp_async16_zfill(cs + p * AROW + j, cache, 0);
    }
    if (tid < nv) cp_async4(posb + (f % AST) * TRA + tid, pos + (size_t)(s0 + tid) * B + b);
  };
#pragma unroll
  for (int f = 0; f < AST - 1; ++f) {
    if (f < ntot) load_a(f);
    cp_async_commit();
  }
  *reinterpret_cast<float2*>(qf + (rank * BP + warp) * QB + qj) =
      make_float2(ql[0], ql[1]);
  cluster::gather(qf, BP * QB);

  // ---- phase 4: online softmax over this rank's share of each slot ----
  // On the tensor cores, with f32 q and p as bf16 hi + lo terms: the
  // scores S = C·q of a tile's rows (the rows as M, two m tiles; warp w
  // takes the latent k steps of its 64 columns and, warps 0-3, one rope k
  // step; q the only real n column), summed over the warps in warp order;
  // every warp then runs the same online softmax (lane l: row l) and adds
  // p·C to its 64 latent columns of acc (C^T as A, loaded with ldmatrix
  // .trans; p the only real n column).  At a slot's last tile its m and l
  // go to shared memory and its acc columns, two a lane, to registers
  constexpr int MT = TRA / 16;           // score m tiles = PV k steps
  constexpr int NKS = QB / 16 + 1;       // score k steps a warp (+ rope)
  constexpr int NPT = QB / 16;           // PV m tiles a warp
  const int ak = (lane & 7) + ((lane >> 4) << 3), am = ((lane >> 3) & 1) << 3;
  const bool ropew = warp < ROPE / 16;   // the warps with a rope k step
  float ra0[BP], ra1[BP];
#pragma unroll
  for (int b = 0; b < BP; ++b) { ra0[b] = 0.f; ra1[b] = 0.f; }
  if (tid < BP) { rm[tid] = -1e30f; rl[tid] = 0.f; }
  float wm = -1e30f, wl = 0.f, pa[NPT][4];
#pragma unroll
  for (int j = 0; j < NPT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) pa[j][q] = 0.f;
  uint32_t qh[NKS][2], qlo[NKS][2];
  int qslot = -1;
  for (int f = 0; f < ntot; ++f) {
    cp_async_wait<AST - 2>();
    __syncthreads();
    if (f + AST - 1 < ntot) load_a(f + AST - 1);
    cp_async_commit();
    const int b = slot_of(f), t = f - first[b];
    const int s0 = sa[b] + t * TRA, nv = min(TRA, se[b] - s0);
    const int cl = clen[b];
    const bf16* cs = ring_a + (size_t)(f % AST) * TRA * AROW;
    if (b != qslot) {          // q's fragments: lanes of n column 0 only
      qslot = b;
#pragma unroll
      for (int kk = 0; kk < NKS; ++kk) {
        const float* q = kk < NKS - 1 ? qf + (warp * BP + b) * QB + kk * 16
                                      : qr + b * ROPE + warp * 16;
        float2 q0 = make_float2(0.f, 0.f), q8 = q0;
        if (gi == 0 && (kk < NKS - 1 || ropew)) {
          q0 = *reinterpret_cast<const float2*>(q + 2 * ti);
          q8 = *reinterpret_cast<const float2*>(q + 2 * ti + 8);
        }
        split_bf16(q0, qh[kk][0], qlo[kk][0]);
        split_bf16(q8, qh[kk][1], qlo[kk][1]);
      }
    }
    float sacc[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int q = 0; q < 4; ++q) sacc[mt][q] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NKS; ++kk) {
      if (kk == NKS - 1 && !ropew) break;
      const int col = kk < NKS - 1 ? warp * QB + kk * 16 : LAT + warp * 16;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t af[4];
        ldsm_x4(cs + (mt * 16 + (lane & 15)) * AROW + col + (lane >> 4) * 8, af);
        mma_bf16(sacc[mt], af, qh[kk][0], qh[kk][1]);
        mma_bf16(sacc[mt], af, qlo[kk][0], qlo[kk][1]);
      }
    }
    if (ti == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        sc[warp * TRA + mt * 16 + gi] = sacc[mt][0];
        sc[warp * TRA + mt * 16 + gi + 8] = sacc[mt][2];
      }
    }
    __syncthreads();
    float sv = -INFINITY;
    bool valid = false;
    if (lane < nv) {
      const int ps_ = posb[(f % AST) * TRA + lane];
      valid = ps_ >= 0 && ps_ < cl;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) s += sc[w * TRA + lane];
      if (valid) sv = s * scale;
    }
    const float m_new = fmaxf(wm, warp_max(sv)), c = expf(wm - m_new);
    const float pv = valid ? expf(sv - m_new) : 0.f;
    wl = wl * c + warp_sum(pv);
    wm = m_new;
#pragma unroll
    for (int j = 0; j < NPT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) pa[j][q] *= c;
#pragma unroll
    for (int ks = 0; ks < MT; ++ks) {
      const int k0 = ks * 16 + 2 * ti;
      const float p0 = __shfl_sync(0xffffffffu, pv, k0);
      const float p1 = __shfl_sync(0xffffffffu, pv, k0 + 1);
      const float p8 = __shfl_sync(0xffffffffu, pv, k0 + 8);
      const float p9 = __shfl_sync(0xffffffffu, pv, k0 + 9);
      uint32_t bh0, bl0, bh1, bl1;
      split_bf16(gi == 0 ? make_float2(p0, p1) : make_float2(0.f, 0.f), bh0, bl0);
      split_bf16(gi == 0 ? make_float2(p8, p9) : make_float2(0.f, 0.f), bh1, bl1);
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        uint32_t af[4];
        ldsm_x4_t(cs + (ks * 16 + ak) * AROW + warp * QB + j * 16 + am, af);
        mma_bf16(pa[j], af, bh0, bh1);
        mma_bf16(pa[j], af, bl0, bl1);
      }
    }
    if (t == first[b + 1] - first[b] - 1) {   // the slot's last tile
      // column 16j + g of the warp's 64 sits in lane 4·(g mod 8), c0 for
      // g < 8, c2 above; lane L takes columns 2L and 2L + 1
      const int jl = 2 * (lane & 7);
      float a0 = 0.f, a1 = 0.f;
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        const float x0 = __shfl_sync(0xffffffffu, pa[j][0], 4 * (jl & 7));
        const float x2 = __shfl_sync(0xffffffffu, pa[j][2], 4 * (jl & 7));
        const float y0 = __shfl_sync(0xffffffffu, pa[j][0], 4 * ((jl + 1) & 7));
        const float y2 = __shfl_sync(0xffffffffu, pa[j][2], 4 * ((jl + 1) & 7));
        if ((lane >> 3) == j) {
          a0 = jl < 8 ? x0 : x2;
          a1 = jl < 8 ? y0 : y2;
        }
      }
#pragma unroll
      for (int bb = 0; bb < BP; ++bb)
        if (bb == b) { ra0[bb] = a0; ra1[bb] = a1; }
      if (tid == 0) { rm[b] = wm; rl[b] = wl; }
      wm = -1e30f;
      wl = 0.f;
#pragma unroll
      for (int j = 0; j < NPT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) pa[j][q] = 0.f;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // this rank's partial m[BP], l[BP], acc[BP][LAT] over the latent ring
  float* aacc = apart + cluster::acc_offset(BP);
#pragma unroll
  for (int b = 0; b < BP; ++b)
    *reinterpret_cast<float2*>(aacc + b * LAT + warp * QB + 2 * lane) =
        make_float2(ra0[b], ra1[b]);
  if (tid < BP) { apart[tid] = rm[tid]; apart[BP + tid] = rl[tid]; }
  // the new token's score against the ROUNDED c_new, gated by include_new
  if (warp < B) {
    const int b = warp;
    const float* q = qf + ((lane / 4) * BP + b) * QB + (lane % 4) * 16;
    const bf16* cr = cn_s + b * LR + lane * 16;
    float dot = 0.f;
#pragma unroll
    for (int k = 0; k < 16; k += 8) {
      float c8[8];
      smem_bf16x8(cr + k, c8);
#pragma unroll
      for (int e = 0; e < 8; ++e) dot += q[k + e] * c8[e];
    }
    dot += qr[b * ROPE + 2 * lane] * bf2f(cn_s[b * LR + LAT + 2 * lane])
         + qr[b * ROPE + 2 * lane + 1] * bf2f(cn_s[b * LR + LAT + 2 * lane + 1]);
    dot = warp_sum(dot);
    if (lane == 0) snew[b] = include_new[b] > 0 ? dot * scale : -1e30f;
  }

  // the first wproj tiles go in flight before the merge (below the
  // attention partial, which the merge reads)
  bf16* ring_o = reinterpret_cast<bf16*>(r0);
  const bf16* wph = wproj + (size_t)h * LAT * D + d0;
  auto load_o = [&](int t) {
    if (t >= NKO) return;
    bf16* dst = ring_o + (size_t)(t % OST) * TK * xrow;
    for (int i = tid; i < TK * (Dr / 8); i += NT) {
      const int p = i / (Dr / 8), j = (i % (Dr / 8)) * 8;
      cp_async16(dst + p * xrow + j, wph + (size_t)(t * TK + p) * D + j);
    }
  };
  for (int t = 0; t < OPRE; ++t) {
    load_o(t);
    cp_async_commit();
  }

  // ---- phase 5: (m, l, acc) merged over the cluster, in rank order ----
  cluster::flash_merge(apart, BP, LAT, 0, B * LAT,
                       [&](int e, float m, float l, float4 a) {
    const int b = e / LAT, d = e % LAT;
    *reinterpret_cast<float4*>(acc2 + b * ACS + d) = a;
    if (d == 0) { mfin[b] = m; lfin[b] = l; }
  });
  // the attention partial is free: the rest of the ring goes in flight
  for (int t = OPRE; t < OST - 1; ++t) {
    load_o(t);
    cp_async_commit();
  }
  __syncthreads();
  if (tid < B) {
    const int b = tid;
    const float m_fin = fmaxf(mfin[b], snew[b]);
    const float p = expf(snew[b] - m_fin), c = expf(mfin[b] - m_fin);
    cnf[b] = c;
    pnf[b] = p;
    if (rank == 0) {
      m_out[(size_t)b * nq + h] = m_fin;
      l_out[(size_t)b * nq + h] = lfin[b] * c + p;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < BP * LAT; idx += NT) {
    const int b = idx / LAT, d = idx % LAT;
    acc2[b * ACS + d] = b < B ? acc2[b * ACS + d] * cnf[b]
                                    + pnf[b] * bf2f(cn_s[b * LR + d])
                              : 0.f;
  }

  // ---- phase 6: o[b, h, d0 + :Dr] = acc[b, :] · wproj[h][:, d0 + :Dr] --
  // warp w: columns [w·Dr/8, (w+1)·Dr/8) as Dr/64 n tiles; A = acc as
  // bf16 hi + lo terms (rows 8-15 zero)
  const int nto = Dr / 64;
  float co[MAX_NTO][4];
#pragma unroll
  for (int n = 0; n < MAX_NTO; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) co[n][j] = 0.f;
  for (int t = 0; t < NKO; ++t) {
    cp_async_wait<OST - 2>();
    __syncthreads();
    load_o(t + OST - 1);
    cp_async_commit();
    const bf16* tile = ring_o + (size_t)(t % OST) * TK * xrow;
    const float* ar = acc2 + gi * ACS + t * TK + ti * 2;
    uint32_t ahi[4] = {0u, 0u, 0u, 0u}, alo[4] = {0u, 0u, 0u, 0u};
    split_bf16(*reinterpret_cast<const float2*>(ar), ahi[0], alo[0]);
    split_bf16(*reinterpret_cast<const float2*>(ar + 8), ahi[2], alo[2]);
    const bf16* tb = tile + ((lane & 7) + (mi & 1) * 8) * xrow
                   + warp * (Dr / NW) + (mi >> 1) * 8;
#pragma unroll
    for (int n = 0; n < MAX_NTO; n += 2) {
      if (n < nto) {
        uint32_t bq[4];
        ldsm_x4_t(tb + n * 8, bq);
        mma_bf16(co[n], ahi, bq[0], bq[1]);
        mma_bf16(co[n], alo, bq[0], bq[1]);
        mma_bf16(co[n + 1], ahi, bq[2], bq[3]);
        mma_bf16(co[n + 1], alo, bq[2], bq[3]);
      }
    }
  }
  cp_async_wait<0>();
  if (gi < B) {
    float* orow = o + ((size_t)gi * nq + h) * D + d0 + warp * (Dr / NW) + ti * 2;
#pragma unroll
    for (int n = 0; n < MAX_NTO; ++n)
      if (n < nto)
        *reinterpret_cast<float2*>(orow + n * 8) = make_float2(co[n][0], co[n][1]);
  }
}

// ---- launch 1: c_new = [c_lat | RoPE(c_rope)] of rms(x, ln1)·wdkv ------
// One cluster of CL CTAs per CQ columns of wdkv (9 clusters; the last
// holds the 64 rope columns): rank r normalizes its rows [r·D/8,
// (r+1)·D/8) of x as the main launch does (the sums of squares summed over
// the cluster in rank order), multiplies them by its rows of the
// cluster's columns on the tensor cores (warp w: k steps w, w + 8, …,
// the warps' partials summed in warp order), the ranks' partials are
// summed in rank order (cluster::sum), and rank 0 applies RoPE in f32 and
// writes the columns rounded to the cache dtype.  Launch 2 reads c_new:
// every head attends the same rounded entry.
struct LayC {
  int Dr;
  __host__ __device__ int xrow() const { return Dr + 8; }
  __host__ __device__ size_t wt() const { return (size_t)BP * xrow() * 2; }
  __host__ __device__ size_t ln1s() const { return wt() + (size_t)Dr * WROW * 2; }
  __host__ __device__ size_t wpart() const { return ln1s() + (size_t)Dr * 4; }
  __host__ __device__ size_t cp() const { return wpart() + (size_t)NW * BP * CQ * 4; }
  // cp, cs [BP·CQ]; red_ss [NW·BP] ssp ssa inv [BP]
  __host__ __device__ size_t total() const {
    return cp() + (size_t)(2 * BP * CQ + NW * BP + 3 * BP) * 4;
  }
};

template <int B>
__global__ void __launch_bounds__(NT)
mla_ckv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wdkv,
               const float* __restrict__ ln1, const float* __restrict__ cosv,
               const float* __restrict__ sinv, bf16* __restrict__ c_new, int D,
               float eps) {
  const int rank = blockIdx.x % CL, j = blockIdx.x / CL;
  const LayC L{D / CL};
  const int Dr = L.Dr, d0 = rank * Dr, xrow = L.xrow();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gi = lane >> 2, ti = lane & 3, mi = lane >> 3;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* wt = reinterpret_cast<bf16*>(smem + L.wt());
  float* ln1s = reinterpret_cast<float*>(smem + L.ln1s());
  float* wpart = reinterpret_cast<float*>(smem + L.wpart());
  float* cp = reinterpret_cast<float*>(smem + L.cp());
  float* cs = cp + BP * CQ;
  float* red_ss = cs + BP * CQ;
  float* ssp = red_ss + NW * BP;
  float* ssa = ssp + BP;
  float* inv = ssa + BP;

  for (int i = tid; i < Dr / 4; i += NT) cp_async16(ln1s + i * 4, ln1 + d0 + i * 4);
  for (int i = tid; i < Dr * (CQ / 8); i += NT) {
    const int r = i / (CQ / 8), c = (i % (CQ / 8)) * 8;
    cp_async16(wt + r * WROW + c, wdkv + (size_t)(d0 + r) * LR + j * CQ + c);
  }
  cp_async_commit();
  {
    float ss[B];
#pragma unroll
    for (int b = 0; b < B; ++b) ss[b] = 0.f;
    for (int i = tid; i < Dr / 8; i += NT) {
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(x + (size_t)b * D + d0) + i);
        const float v8[8] = {lo_bf(u.x), hi_bf(u.x), lo_bf(u.y), hi_bf(u.y),
                             lo_bf(u.z), hi_bf(u.z), lo_bf(u.w), hi_bf(u.w)};
#pragma unroll
        for (int k = 0; k < 8; ++k) ss[b] += v8[k] * v8[k];
        *reinterpret_cast<uint4*>(xs + b * xrow + i * 8) = u;
      }
    }
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const float s = warp_sum(ss[b]);
      if (lane == 0) red_ss[warp * BP + b] = s;
    }
    __syncthreads();
    if (tid < BP) {
      float s = 0.f;
      if (tid < B)
        for (int w = 0; w < NW; ++w) s += red_ss[w * BP + tid];
      ssp[tid] = s;
    }
    cluster::sum(ssp, ssa, 0, BP);
    if (tid < B) inv[tid] = 1.0f / sqrtf(ssa[tid] / (float)D + eps);
    cp_async_wait<0>();
    __syncthreads();
    for (int i = tid; i < BP * (Dr / 8); i += NT) {
      const int b = i / (Dr / 8), c = (i % (Dr / 8)) * 8;
      bf16* xr = xs + b * xrow + c;
      if (b >= B) {
        *reinterpret_cast<uint4*>(xr) = make_uint4(0u, 0u, 0u, 0u);
        continue;
      }
      float v8[8];
      smem_bf16x8(xr, v8);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        xr[k] = f2bf(v8[k] * inv[b] * (1.0f + ln1s[c + k]));
    }
    __syncthreads();
  }
  float acc[CQ / 8][4];
#pragma unroll
  for (int n = 0; n < CQ / 8; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[n][q] = 0.f;
  for (int k = warp; k < Dr / TK; k += NW) {
    const bf16* xa = xs + gi * xrow + k * TK + ti * 2;
    const uint32_t af[4] = {lds32(xa), 0u, lds32(xa + 8), 0u};
    const bf16* tb = wt + (k * TK + (lane & 7) + (mi & 1) * 8) * WROW + (mi >> 1) * 8;
#pragma unroll
    for (int n = 0; n < CQ / 8; n += 2) {
      uint32_t bq[4];
      ldsm_x4_t(tb + n * 8, bq);
      mma_bf16(acc[n], af, bq[0], bq[1]);
      mma_bf16(acc[n + 1], af, bq[2], bq[3]);
    }
  }
  if (gi < B) {
#pragma unroll
    for (int n = 0; n < CQ / 8; ++n)
      *reinterpret_cast<float2*>(wpart + (warp * BP + gi) * CQ + n * 8 + ti * 2) =
          make_float2(acc[n][0], acc[n][1]);
  }
  __syncthreads();
  for (int i = tid; i < B * CQ; i += NT) {
    float s = 0.f;
    for (int w = 0; w < NW; ++w) s += wpart[w * BP * CQ + i];
    cp[i] = s;
  }
  cluster::sum(cp, cs, 0, B * CQ);
  if (rank != 0) return;
  constexpr int HALF = ROPE / 2;
  for (int i = tid; i < B * CQ; i += NT) {
    const int b = i / CQ, k = i % CQ, col = j * CQ + k;
    float v = cs[i];
    if (col >= LAT) {                   // the rope cluster: k = col − LAT
      const int r = k % HALF;
      const float c = cosv[b * HALF + r], s = sinv[b * HALF + r];
      const float t1 = cs[b * CQ + r], t2 = cs[b * CQ + HALF + r];
      v = k < HALF ? t1 * c - t2 * s : t2 * c + t1 * s;
    }
    c_new[(size_t)b * LR + col] = f2bf(v);
  }
}
static_assert(LAT % CQ == 0 && ROPE == CQ, "launch 1's last cluster: the rope columns");

// Rows a rank may hold: a multiple of 64 (eight warps' n tiles of wproj,
// and of 16 for the projection's k steps) up to 512 (MAX_NTO).
bool rows_ok(int Dr) { return Dr >= 64 && Dr <= 64 * MAX_NTO && Dr % 64 == 0; }

template <int B>
int launch(const bf16* x, const bf16* wq, const bf16* wdkv, const bf16* wuk,
           const bf16* wproj, const float* ln1, const bf16* cache, const int* pos,
           const int* cache_lens, const int* include_new, const float* cosv,
           const float* sinv, float* o, bf16* c_new, float* m, float* l_out,
           int D, int S, int nq, int pos_base, float scale, float eps,
           cudaStream_t stream) {
  const LayC LC{D / CL};
  cudaError_t e = cluster::launch(mla_ckv_kernel<B>, dim3(LR / CQ * CL), NT,
                                  LC.total(), stream, CL, x, wdkv, ln1, cosv,
                                  sinv, c_new, D, eps);
  if (e != cudaSuccess) return (int)e;
  const Lay L{D / CL};
  return (int)cluster::launch(
      fused_mla_decode_kernel<B>, dim3(nq * CL), NT, L.total(), stream, CL,
      x, wq, wuk, wproj, ln1, cache, pos, cache_lens, include_new, cosv,
      sinv, o, (const bf16*)c_new, m, l_out, D, S, nq, pos_base, scale, eps);
}

}  // namespace

extern "C" int fused_mla_decode_launch(
    const void* x, const void* wq, const void* wdkv, const void* wuk,
    const void* wproj, const void* ln1, const void* cache, const void* pos,
    const void* cache_lens, const void* include_new, const void* cosv,
    const void* sinv, void* o, void* c_new, void* m, void* l_out, int B,
    int D, int S, int nq, int nope, int rope, int l, int C, int pos_base,
    float scale, float eps, void* stream) {
  if (nope != NOPE || rope != ROPE || l != LAT || C != CL || D % CL != 0 ||
      !rows_ok(D / CL) || nq < 1 || pos_base < 0)
    return (int)cudaErrorInvalidValue;
#define ARGS (const bf16*)x, (const bf16*)wq, (const bf16*)wdkv, (const bf16*)wuk,   \
    (const bf16*)wproj, (const float*)ln1, (const bf16*)cache, (const int*)pos,      \
    (const int*)cache_lens, (const int*)include_new, (const float*)cosv,             \
    (const float*)sinv, (float*)o, (bf16*)c_new, (float*)m, (float*)l_out, D, S, nq, \
    pos_base, scale, eps, (cudaStream_t)stream
  switch (B) {
    case 1: return launch<1>(ARGS);
    case 2: return launch<2>(ARGS);
    case 3: return launch<3>(ARGS);
    case 4: return launch<4>(ARGS);
    case 5: return launch<5>(ARGS);
    case 6: return launch<6>(ARGS);
    case 7: return launch<7>(ARGS);
    case 8: return launch<8>(ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ARGS
}
