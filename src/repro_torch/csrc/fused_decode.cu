// B1 — fused RMSNorm + QKV-Projection + RoPE + ragged decode attention +
// per-head Output-Projection ("partial_o"), one launch for all B slots.
//
// Replaces repro/kernels/fused_decode/fused_decode.py:fused_decode_attention
// (the Pallas kernel at its pallas_call, line 374) in the serving mode:
// fused ln1, linear cache, no bias/window/softcap, q_per_kv = 1 (MHA).
//
// Bound on an H100: bytes.  Per layer the weights (wqkv + wo, 134 MB at
// Llama2-7B) and each slot's live KV are read once; the arithmetic is a
// few FLOPs per byte.  Design, the paper's (Alg. 1-3): one thread-block
// cluster of C CTAs per kv head (the wrapper's C: 4 at Llama2-7B, 128
// CTAs), the grid and the buffers laid out by kv head.  Rank r of the
// cluster of head g
//   1. normalizes x for all B slots (the sum of squares over the whole
//      row, redundant per rank: 64 KB from L2) and keeps its rows
//      [r·D/C, (r+1)·D/C) in shared memory, rounded to bf16 as the
//      reference rounds before the projection;
//   2. streams those rows of head g's q|k|v columns of wqkv ONCE through
//      a 5-stage cp.async ring (16-byte copies, four tiles in flight while
//      one is computed) and multiplies them on the tensor cores (mma.sync
//      m16n8k16: the B ≤ 8 normed rows, exact in bf16, as the 16-row A
//      operand; each warp owns 48 columns);
//   3. ClusterReduce: the [B, 3·hd] f32 partials are summed in rank order,
//      each rank its slice over DSMEM (cluster::sum), then gathered
//      (cluster::gather), so every rank holds the same q, k and v;
//   4. applies RoPE in f32; rank 0 writes the rounded k_new/v_new;
//   5. attends over its share of the live rows [0, cache_len) of all
//      slots laid end to end (C runs of equal length, in tiles that stop
//      at a slot's edge), rows with pos in [0, cache_len), streaming K/V
//      and pos through a 2-stage cp.async ring (its first tiles load
//      during step 3); each warp scores 8 keys of a tile and keeps its
//      own online softmax from m = -1e30, the eight warps' partials
//      merging in warp order at a slot's end (no barrier inside a tile);
//   6. ClusterReduce with the flash-merge operator: the ranks' (m, l, acc)
//      merge in rank order over DSMEM (cluster::flash_merge), identically
//      on every rank;
//   7. folds in the new token (f32 k/v, gated by include_new) the same
//      way on every rank; rank 0 writes m and l;
//   8. projects acc through columns [r·D/C, (r+1)·D/C) of wo[g] (a
//      2-stage cp.async ring) on the tensor cores, acc split into bf16 hi
//      + lo terms (two mma.sync each: acc kept to ~2^-17), into its slice
//      of o[b, g, :] (unnormalized).
// Every weight byte and every live KV row is read once for the grid;
// partials are summed in a fixed order, with no float atomics.
#include "cluster.cuh"

namespace {

constexpr int NT = 256;        // 8 warps
constexpr int NW = NT / 32;
constexpr int HD = 128;
constexpr int BP = 8;          // slots as laid out in shared memory
constexpr int NC = 3 * HD;     // q | k | v columns of one head
constexpr int NCP = NC + 8;    // padded wqkv tile row (bf16)
constexpr int NTW = NC / 8 / NW;   // 8-column n tiles a warp projects (6)
constexpr int TRW = 16;        // wqkv rows a tile: one k16 step
constexpr int WST = 5;         // wqkv ring stages
constexpr int TRA = 64;        // cache rows a tile
constexpr int RSA = HD + 8;    // padded cache row (bf16)
constexpr int AST = 2;         // cache ring stages
constexpr int TRO = 16;        // wo rows a tile: one k16 step
constexpr int OST = 2;         // wo ring stages
constexpr int ACS = HD + 4;    // acc row stride (f32)
constexpr int MAX_NTO = 16;    // wo n tiles a warp: Dr ≤ 1024

__host__ __device__ constexpr size_t smax(size_t a, size_t b) {
  return a > b ? a : b;
}

// Shared-memory layout for Dr = D / C rows a rank.
template <int B>
struct Lay {
  int Dr;
  __host__ __device__ int xrow() const { return Dr + 8; }   // bf16, padded
  // region 0, reused phase by phase: the wqkv ring, the cache ring, the
  // wo ring
  __host__ __device__ size_t r0() const {
    size_t s = (size_t)WST * TRW * NCP * 2;
    s = smax(s, (size_t)AST * 2 * TRA * RSA * 2);
    return smax(s, (size_t)OST * TRO * xrow() * 2);
  }
  // the normed rows bf16 [BP][xrow], then the projection's partial f32
  // [B][NC], then the warps' attention partials f32 [NW][4 + HD]
  __host__ __device__ size_t xs() const { return r0(); }
  __host__ __device__ size_t qkv() const {
    return xs() + smax(smax((size_t)BP * xrow() * 2, (size_t)B * NC * 4),
                       (size_t)NW * (4 + HD) * 4);
  }
  // this rank's attention partial m[B], l[B], acc[B][HD]
  __host__ __device__ size_t apart() const { return qkv() + (size_t)B * NC * 4; }
  // the merged acc f32 [BP][ACS]
  __host__ __device__ size_t acc2() const {
    return apart() + (size_t)(cluster::acc_offset(B) + B * HD) * 4;
  }
  __host__ __device__ size_t misc() const { return acc2() + (size_t)BP * ACS * 4; }
  // misc: red_ss[NW·BP] inv mfin lfin cn pn [BP]; ints sa se clen [BP]
  //       first[BP + 1] pos tiles [AST][TRA]
  __host__ __device__ size_t total() const {
    return misc() + (size_t)(NW * BP + 5 * BP) * 4
         + (size_t)(4 * BP + 4 + AST * TRA) * 4;
  }
};

template <int B>
__global__ void __launch_bounds__(NT, 2)
fused_decode_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wqkv,
                    const bf16* __restrict__ wo, const float* __restrict__ ln1,
                    const bf16* __restrict__ kc, const bf16* __restrict__ vc,
                    const int* __restrict__ pos, const int* __restrict__ cache_lens,
                    const int* __restrict__ include_new,
                    const float* __restrict__ cosv, const float* __restrict__ sinv,
                    float* __restrict__ o, bf16* __restrict__ k_new,
                    bf16* __restrict__ v_new, float* __restrict__ m_out,
                    float* __restrict__ l_out, int D, int S, int nq, int nkv,
                    float scale, float eps) {
  const int C = (int)cooperative_groups::this_cluster().num_blocks();
  const int rank = blockIdx.x % C, g = blockIdx.x / C;   // g: kv head
  const Lay<B> L{D / C};
  const int Dr = L.Dr, d0 = rank * Dr, xrow = L.xrow();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gi = lane >> 2, ti = lane & 3, mi = lane >> 3;   // fragments
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* r0 = smem;
  bf16* xs = reinterpret_cast<bf16*>(smem + L.xs());
  float* part = reinterpret_cast<float*>(smem + L.xs());   // after phase 2
  float* qkv = reinterpret_cast<float*>(smem + L.qkv());
  float* am = reinterpret_cast<float*>(smem + L.apart());
  float* al = am + B;
  float* aacc = am + cluster::acc_offset(B);
  float* acc2 = reinterpret_cast<float*>(smem + L.acc2());
  float* red_ss = reinterpret_cast<float*>(smem + L.misc());
  float* inv = red_ss + NW * BP;
  float* mfin = inv + BP;
  float* lfin = mfin + BP;
  float* cn = lfin + BP;
  float* pn = cn + BP;
  int* sa = reinterpret_cast<int*>(pn + BP);
  int* se = sa + BP;
  int* clen = se + BP;
  int* first = clen + BP;            // [BP + 1] prefix of tiles by slot
  int* posb = first + BP + 4;        // [AST][TRA]

  // ---- phase 2 prologue: the first wqkv tiles go in flight at once ----
  const int P = (nq + 2 * nkv) * HD;
  const int ntw = Dr / TRW;
  bf16* ring_w = reinterpret_cast<bf16*>(r0);
  auto load_w = [&](int t) {
    bf16* dst = ring_w + (size_t)(t % WST) * TRW * NCP;
    const int rb = t * TRW;
    for (int i = tid; i < TRW * (NC / 8); i += NT) {
      const int p = i / (NC / 8), j = i % (NC / 8), sec = j / (HD / 8);
      const int col = (sec == 0 ? 0 : (sec == 1 ? nq : nq + nkv)) * HD
                    + g * HD + (j % (HD / 8)) * 8;
      cp_async16(dst + p * NCP + j * 8, wqkv + (size_t)(d0 + rb + p) * P + col);
    }
  };
#pragma unroll
  for (int t = 0; t < WST - 1; ++t) {
    if (t < ntw) load_w(t);
    cp_async_commit();
  }

  // this rank's share of the live rows: slot by slot, the rows [0, L_b)
  // laid end to end and cut into C runs of equal length, each run in
  // tiles of TRA rows that stop at a slot's edge
  if (tid < BP) clen[tid] = tid < B ? cache_lens[tid] : 0;
  __syncthreads();
  if (tid == 0) {
    int Lb[BP], tot = 0;
    for (int b = 0; b < BP; ++b) {
      const int cl = clen[b];
      Lb[b] = cl < 0 ? 0 : (cl < S ? cl : S);
      tot += Lb[b];
    }
    const int per = (tot + C - 1) / C;
    const int R0 = min(tot, rank * per), R1 = min(tot, R0 + per);
    int f = 0, off = 0;
    for (int b = 0; b < BP; ++b) {
      sa[b] = min(Lb[b], max(0, R0 - off));
      se[b] = min(Lb[b], max(0, R1 - off));
      first[b] = f;
      f += (se[b] - sa[b] + TRA - 1) / TRA;
      off += Lb[b];
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

  // ---- phase 2: rows [d0, d0 + Dr) of head g's q|k|v columns ----------
  // warp w: columns [48w, 48w + 48) as six n tiles; A = the normed rows
  // (rows 8-15 of the m16 tile are zero: B ≤ 8)
  float cw[NTW][4];
#pragma unroll
  for (int n = 0; n < NTW; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) cw[n][j] = 0.f;
  for (int t = 0; t < ntw; ++t) {
    // tile t has landed, and no thread still reads the stage that tile
    // t + WST - 1 overwrites
    cp_async_wait<WST - 2>();
    __syncthreads();
    if (t + WST - 1 < ntw) load_w(t + WST - 1);
    cp_async_commit();
    const bf16* tile = ring_w + (size_t)(t % WST) * TRW * NCP;
    const bf16* xa = xs + gi * xrow + t * TRW + ti * 2;
    const uint32_t af[4] = {lds32(xa), 0u, lds32(xa + 8), 0u};
    const bf16* tb = tile + ((lane & 7) + (mi & 1) * 8) * NCP
                   + warp * NTW * 8 + (mi >> 1) * 8;
#pragma unroll
    for (int n = 0; n < NTW; n += 2) {
      uint32_t bq[4];
      ldsm_x4_t(tb + n * 8, bq);
      mma_bf16(cw[n], af, bq[0], bq[1]);
      mma_bf16(cw[n + 1], af, bq[2], bq[3]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

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
    const int b = slot_of(f), s0 = sa[b] + (f - first[b]) * TRA;
    const int nv = min(TRA, se[b] - s0);
    bf16* ks = ring_a + (size_t)(f % AST) * 2 * TRA * RSA;
    bf16* vs = ks + TRA * RSA;
    const size_t col = ((size_t)b * nkv + g) * HD;
    for (int i = tid; i < nv * (HD / 8); i += NT) {
      const int p = i / (HD / 8), j = (i % (HD / 8)) * 8;
      const size_t off = (size_t)(s0 + p) * srow + col + j;
      cp_async16(ks + p * RSA + j, kc + off);
      cp_async16(vs + p * RSA + j, vc + off);
    }
    if (tid < nv) cp_async4(posb + (f % AST) * TRA + tid, pos + (size_t)(s0 + tid) * B + b);
  };
#pragma unroll
  for (int f = 0; f < AST - 1; ++f) {
    if (f < ntot) load_a(f);
    cp_async_commit();
  }

  // this rank's [B][NC] partial (slots past B dropped), over xs
#pragma unroll
  for (int n = 0; n < NTW; ++n)
    if (gi < B)
      *reinterpret_cast<float2*>(part + gi * NC + (warp * NTW + n) * 8 + ti * 2) =
          make_float2(cw[n][0], cw[n][1]);
  // ClusterReduce: each rank sums its slice in rank order, then gathers
  {
    const int n = B * NC / C;
    cluster::sum(part, qkv, rank * n, (rank + 1) * n);
    cluster::gather(qkv, n);
  }

  // ---- phase 3: RoPE (rotate halves) on q and k, in f32 ---------------
  constexpr int HALF = HD / 2;
  for (int idx = tid; idx < B * HALF; idx += NT) {
    const int b = idx / HALF, i = idx % HALF;
    const float c = cosv[b * HALF + i], s = sinv[b * HALF + i];
    float* qr = qkv + b * NC;
    float* kr = qr + HD;
    const float q1 = qr[i], q2 = qr[i + HALF];
    qr[i] = q1 * c - q2 * s;
    qr[i + HALF] = q2 * c + q1 * s;
    const float k1 = kr[i], k2 = kr[i + HALF];
    kr[i] = k1 * c - k2 * s;
    kr[i + HALF] = k2 * c + k1 * s;
  }
  for (int i = tid; i < B * HD; i += NT) aacc[i] = 0.f;
  if (tid < B) { am[tid] = -1e30f; al[tid] = 0.f; }
  __syncthreads();
  if (rank == 0) {
    for (int idx = tid; idx < B * HD; idx += NT) {
      const int b = idx / HD, d = idx % HD;
      k_new[((size_t)b * nkv + g) * HD + d] = f2bf(qkv[b * NC + HD + d]);
      v_new[((size_t)b * nkv + g) * HD + d] = f2bf(qkv[b * NC + 2 * HD + d]);
    }
  }

  // ---- phase 4: online softmax over this rank's share of each slot ----
  // warp-split: warp w scores keys 8w .. 8w + 7 of a tile (four lanes a
  // key) and keeps its own running m, l and acc (its lane's four
  // columns), so a tile needs no barrier of its own; at a slot's last
  // tile the eight warps' partials merge in warp order
  static_assert(TRA == 8 * NW && HD == 4 * 32, "warp-split geometry");
  float* wpart = reinterpret_cast<float*>(smem + L.xs());   // [NW][4 + HD]
  float wm = -1e30f, wl = 0.f, wacc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int f = 0; f < ntot; ++f) {
    cp_async_wait<AST - 2>();
    __syncthreads();
    if (f + AST - 1 < ntot) load_a(f + AST - 1);
    cp_async_commit();
    const int b = slot_of(f), t = f - first[b];
    const int s0 = sa[b] + t * TRA, nv = min(TRA, se[b] - s0);
    const int cl = clen[b];
    const bf16* ks = ring_a + (size_t)(f % AST) * 2 * TRA * RSA;
    const bf16* vs = ks + TRA * RSA;
    // scores: four lanes a cache row
    const int p = tid >> 2, l4 = tid & 3;
    bool valid = false;
    float d = 0.f;
    if (p < nv) {
      const int ps_ = posb[(f % AST) * TRA + p];
      valid = ps_ >= 0 && ps_ < cl;
      const float* qr = qkv + b * NC;
#pragma unroll
      for (int u = 0; u < HD / 32; ++u) {
        const int j = l4 * 8 + 32 * u;
        float k8[8];
        smem_bf16x8(ks + p * RSA + j, k8);
        const float4 qa = *reinterpret_cast<const float4*>(qr + j);
        const float4 qb = *reinterpret_cast<const float4*>(qr + j + 4);
        d += qa.x * k8[0] + qa.y * k8[1] + qa.z * k8[2] + qa.w * k8[3]
           + qb.x * k8[4] + qb.y * k8[5] + qb.z * k8[6] + qb.w * k8[7];
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    const float sv = valid ? d * scale : -INFINITY;
    // the warp's online softmax over its eight keys
    float mx = sv;
#pragma unroll
    for (int u = 4; u < 32; u <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, u));
    const float m_new = fmaxf(wm, mx), c = expf(wm - m_new);
    const float pv = valid ? expf(sv - m_new) : 0.f;
    float sum = pv;
#pragma unroll
    for (int u = 4; u < 32; u <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, u);
    wl = wl * c + sum;
    wm = m_new;
#pragma unroll
    for (int u = 0; u < 4; ++u) wacc[u] *= c;
    // p·v, p in f32: key kk's p from lane 4·kk; lane owns columns 4·lane ..
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int row = warp * 8 + kk;
      if (row >= nv) break;
      const float pk = __shfl_sync(0xffffffffu, pv, kk * 4);
      float v4[4];
      load_bf16x4_smem(vs + row * RSA + lane * 4, v4);
#pragma unroll
      for (int u = 0; u < 4; ++u) wacc[u] += pk * v4[u];
    }
    if (t == first[b + 1] - first[b] - 1) {   // the slot's last tile
      float* wp = wpart + warp * (4 + HD);
      if (lane == 0) { wp[0] = wm; wp[1] = wl; }
      *reinterpret_cast<float4*>(wp + 4 + lane * 4) =
          make_float4(wacc[0], wacc[1], wacc[2], wacc[3]);
      wm = -1e30f;
      wl = 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u) wacc[u] = 0.f;
      __syncthreads();
      if (tid < HD) {
        float m = -1e30f, l = 0.f, a_ = 0.f;
        for (int w = 0; w < NW; ++w) {
          const float* pw = wpart + w * (4 + HD);
          const float mw = pw[0], mn = fmaxf(m, mw);
          const float ca = expf(m - mn), cb = expf(mw - mn);
          l = l * ca + pw[1] * cb;
          a_ = a_ * ca + pw[4 + tid] * cb;
          m = mn;
        }
        aacc[b * HD + tid] = a_;
        if (tid == 0) { am[b] = m; al[b] = l; }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the first wo tiles go in flight before the merge
  bf16* ring_o = reinterpret_cast<bf16*>(r0);
  const bf16* wog = wo + (size_t)g * HD * D + d0;
  auto load_o = [&](int t) {
    bf16* dst = ring_o + (size_t)(t % OST) * TRO * xrow;
    const int rb = t * TRO;
    for (int i = tid; i < TRO * (Dr / 8); i += NT) {
      const int p = i / (Dr / 8), j = (i % (Dr / 8)) * 8;
      cp_async16(dst + p * xrow + j, wog + (size_t)(rb + p) * D + j);
    }
  };
#pragma unroll
  for (int t = 0; t < OST - 1; ++t) {
    load_o(t);
    cp_async_commit();
  }

  // ---- phase 5: (m, l, acc) merged over the cluster, in rank order ----
  cluster::flash_merge(am, B, HD, 0, B * HD,
                       [&](int e, float m, float l, float4 a) {
    const int b = e / HD, d = e % HD;
    *reinterpret_cast<float4*>(acc2 + b * ACS + d) = a;
    if (d == 0) { mfin[b] = m; lfin[b] = l; }
  });
  __syncthreads();

  // ---- phase 6: the new token (f32 k/v), gated by include_new --------
  for (int b = warp; b < B; b += NW) {
    float dot = 0.f;
    for (int d = lane; d < HD; d += 32) dot += qkv[b * NC + d] * qkv[b * NC + HD + d];
    dot = warp_sum(dot);
    if (lane == 0) {
      const float s_new = include_new[b] > 0 ? dot * scale : -1e30f;
      const float m_fin = fmaxf(mfin[b], s_new);
      const float p = expf(s_new - m_fin);
      const float c = expf(mfin[b] - m_fin);
      const float l_fin = lfin[b] * c + p;
      cn[b] = c;
      pn[b] = p;
      if (rank == 0) {
        m_out[(size_t)b * nq + g] = m_fin;
        l_out[(size_t)b * nq + g] = l_fin;
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < BP * HD; idx += NT) {
    const int b = idx / HD, d = idx % HD;
    acc2[b * ACS + d] =
        b < B ? acc2[b * ACS + d] * cn[b] + pn[b] * qkv[b * NC + 2 * HD + d] : 0.f;
  }

  // ---- phase 7: o[b, g, d0 + :Dr] = acc[b, :] · wo[g][:, d0 + :Dr] -----
  // warp w: columns [w·Dr/8, (w+1)·Dr/8) as Dr/64 n tiles; A = acc as
  // bf16 hi + lo terms (rows 8-15 zero)
  const int nto = Dr / 64;
  float co[MAX_NTO][4];
#pragma unroll
  for (int n = 0; n < MAX_NTO; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) co[n][j] = 0.f;
  for (int t = 0; t < HD / TRO; ++t) {
    cp_async_wait<OST - 2>();
    __syncthreads();
    if (t + OST - 1 < HD / TRO) load_o(t + OST - 1);
    cp_async_commit();
    const bf16* tile = ring_o + (size_t)(t % OST) * TRO * xrow;
    const float* ar = acc2 + gi * ACS + t * TRO + ti * 2;
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
    float* orow = o + ((size_t)gi * nq + g) * D + d0 + warp * (Dr / NW) + ti * 2;
#pragma unroll
    for (int n = 0; n < MAX_NTO; ++n)
      if (n < nto)
        *reinterpret_cast<float2*>(orow + n * 8) = make_float2(co[n][0], co[n][1]);
  }
}

// Rows a rank may hold: a multiple of 64 (eight warps' n tiles of wo) up
// to 1024 (MAX_NTO).
bool rows_ok(int Dr) { return Dr >= 64 && Dr <= 64 * MAX_NTO && Dr % 64 == 0; }

template <int B>
int launch(int C, const bf16* x, const bf16* wqkv, const bf16* wo,
           const float* ln1, const bf16* kc, const bf16* vc, const int* pos,
           const int* cache_lens, const int* include_new, const float* cosv,
           const float* sinv, float* o, bf16* k_new, bf16* v_new, float* m,
           float* l, int D, int S, int nq, int nkv, float scale, float eps,
           cudaStream_t stream) {
  const Lay<B> L{D / C};
  return (int)cluster::launch(
      fused_decode_kernel<B>, dim3(nkv * C), NT, L.total(), stream, C, x,
      wqkv, wo, ln1, kc, vc, pos, cache_lens, include_new, cosv, sinv, o,
      k_new, v_new, m, l, D, S, nq, nkv, scale, eps);
}

}  // namespace

extern "C" int fused_decode_launch(
    const void* x, const void* wqkv, const void* wo, const void* ln1,
    const void* kc, const void* vc, const void* pos, const void* cache_lens,
    const void* include_new, const void* cosv, const void* sinv, void* o,
    void* k_new, void* v_new, void* m, void* l, int B, int D, int S, int nq,
    int nkv, int hd, int C, float scale, float eps, void* stream) {
  if (nq != nkv || hd != HD || C < 1 || D % C != 0 || !rows_ok(D / C))
    return (int)cudaErrorInvalidValue;
#define ARGS C, (const bf16*)x, (const bf16*)wqkv, (const bf16*)wo, (const float*)ln1, \
    (const bf16*)kc, (const bf16*)vc, (const int*)pos, (const int*)cache_lens,           \
    (const int*)include_new, (const float*)cosv, (const float*)sinv, (float*)o,          \
    (bf16*)k_new, (bf16*)v_new, (float*)m, (float*)l, D, S, nq, nkv, scale, eps,         \
    (cudaStream_t)stream
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
