// B3 — fused LM-head / sampling tail: final RMSNorm, f32 logits over the
// vocabulary, per-slot top-k under (value desc, index asc).  One device
// launch; the [B, V] logits never reach device memory.
//
// Replaces repro/kernels/fused_head/fused_head.py:fused_head_block (the
// Pallas kernel at its pallas_call, line 128) with topk.select_topk and
// topk.topk_pair_merge, with or without the logit softcap.
//
// Bound on an H100: bytes — the [V, D] bf16 table (262 MB at Llama2-7B) is
// read once per step for all B ≤ 8 slots, at 2·B FLOPs per element.
// Design: G thread-block clusters of C CTAs (the wrapper's cluster_plan:
// 15 clusters of 8, 120 CTAs, at every served width — as many as an H100
// runs at once at one CTA an SM), all resident in one wave.
//   1. CTA q of the grid owns a contiguous run of V / (G·C) vocabulary
//      rows (one more for the first V % (G·C) CTAs; the rows past a run
//      in its last 16-row block are masked, so V needs no divisor).  It
//      streams its run through a ring of ST = 4 stages (fewer beside a
//      wide h: stages()) of RB = 16 rows × KC = 1024 columns (2 KB runs of
//      a row: longer runs than 512 B read faster) in shared memory with
//      cp.async; the first ST − 1 stages are in flight before it computes
//      the rounded final norm h
//      = bf16(rms(x, ln)) into shared memory (x itself is copied in first,
//      ahead of the table in the memory system's queues), so the norm
//      hides under the loads.
//   2. Logits on the tensor cores: mma.sync m16n8k16 with 16 table rows as
//      A (ldmatrix) and the 8 slots of h as n.  Warp w takes k16 steps
//      8w … 8w + 7 of every stage (each h fragment it reads serves the
//      stage's RB / 16 tiles).  Every 4 k16 steps (64 dims) the product
//      starts from a zero C fragment and is added to the running f32 sum
//      on the CUDA cores, so the tensor cores' own rounding of their
//      accumulator touches only 64-term partials; the eight warps' sums
//      of a 16-row block are then added in warp order.
//   3. Warp s keeps slot s's running top-8 in registers over the whole run
//      (LaneTopK), each logit softcapped (tanh(l/cap)·cap, Gemma-2's 30)
//      BEFORE it enters: f32 rounding can make two different logits equal
//      after the cap, and the tie then goes to the lower index, as in the
//      reference (fused_head.py:79-80), which capping only the survivors
//      would not give; it writes its K best to shared memory at the end.
//   4. ClusterReduce with the top-k operator over DSMEM
//      (cluster::topk): rank c merges the C ranks' candidates of the slots
//      s ≡ c (mod C) and writes the cluster's [B, K] candidates to the
//      [G, B, K] partials; then the last cluster to arrive at each rank's
//      arrival counter (cluster::last_arrival) merges the G clusters'
//      candidates of those slots into the output and resets the counter.
// The selection does no arithmetic, so a second launch gives the same
// bits; no float atomics, no host work inside a call.
#include "cluster.cuh"

namespace {

constexpr int NT = 256;        // 8 warps
constexpr int NW = NT / 32;
constexpr int BP = 8;          // slots as laid out: the MMA's n; warp s ↔ slot s
constexpr int RB = 16;         // vocab rows a stage
constexpr int KC = 1024;       // table columns a stage: 2 KB of a row
constexpr int RT = RB / 16;    // m16 tiles a stage
constexpr int KW = KC / 16 / NW;   // k16 steps a warp a stage
constexpr int KS = 4;          // k16 steps a fresh C fragment sums (64 dims)
constexpr int ARS = KC + 8;    // ring row stride (bf16): conflict-free ldmatrix
constexpr int RRS = RB + 4;    // partial-logit row stride (f32)
constexpr int PIECES = RB * KC / 8 / NT;   // 16-byte loads a thread a stage
constexpr int MAX_ST = 4;      // ring stages
constexpr size_t SMEM_MAX = 232448;   // an H100 block's shared-memory limit
static_assert(KC % (8 * 32) == 0 && RB * KC % (8 * NT) == 0 && KW % KS == 0,
              "a warp loads whole 512-byte runs of a row");

struct Lay {
  int D, st;
  __host__ __device__ int dp() const { return (D + KC - 1) / KC * KC; }
  __host__ __device__ int hrow() const { return dp() + 8; }   // bf16, padded
  __host__ __device__ static size_t stage() { return (size_t)RB * ARS * 2; }
  // ring [st][RB][ARS] bf16; h [BP][hrow] bf16; the warps' partial logits
  // [NW][BP][RRS] f32 (before the scan: the norm's scratch); the
  // candidates [BP][8] f32 and int; the last-arrival flag
  __host__ __device__ size_t hs() const { return st * stage(); }
  __host__ __device__ size_t red() const { return hs() + (size_t)BP * hrow() * 2; }
  __host__ __device__ size_t cand() const { return red() + (size_t)NW * BP * RRS * 4; }
  __host__ __device__ size_t total() const {
    return cand() + (size_t)BP * TOPK_MAXK * 8 + 16;
  }
};

// the most ring stages (≤ MAX_ST, ≥ 2) that fit beside h at width D; 0 if
// even two do not
int stages(int D) {
  for (int st = MAX_ST; st >= 2; --st)
    if (Lay{D, st}.total() <= SMEM_MAX) return st;
  return 0;
}

// h = bf16(rms(x, ln)) in place in shared rows of stride hrow that
// already hold x — the reference's rms_norm (x · (1/sqrt(mean(x²) + eps))
// · (1 + ln) in f32, rounded to the model dtype), as common.cuh's
// rms_rows_to_smem computes it.  `red` holds NW·B + B floats.  Ends with
// a barrier.
template <int B>
DEVI void head_norm(const float* __restrict__ ln, int D, float eps, bf16* hs,
                    int hrow, float* red) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float ss[B];
#pragma unroll
  for (int b = 0; b < B; ++b) ss[b] = 0.f;
  for (int c = tid * 8; c < D; c += NT * 8) {
#pragma unroll
    for (int b = 0; b < B; ++b) {
      float v8[8];
      smem_bf16x8(hs + b * hrow + c, v8);
#pragma unroll
      for (int e = 0; e < 8; ++e) ss[b] += v8[e] * v8[e];
    }
  }
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const float s = warp_sum(ss[b]);
    if (lane == 0) red[warp * B + b] = s;
  }
  __syncthreads();
  float* inv = red + NW * B;
  if (tid < B) {
    float s = 0.f;
    for (int w = 0; w < NW; ++w) s += red[w * B + tid];
    inv[tid] = 1.0f / sqrtf(s / (float)D + eps);
  }
  __syncthreads();
  for (int c = tid * 8; c < D; c += NT * 8) {
    const float4 g0 = __ldg(reinterpret_cast<const float4*>(ln + c));
    const float4 g1 = __ldg(reinterpret_cast<const float4*>(ln + c + 4));
    const float g[8] = {1.0f + g0.x, 1.0f + g0.y, 1.0f + g0.z, 1.0f + g0.w,
                        1.0f + g1.x, 1.0f + g1.y, 1.0f + g1.z, 1.0f + g1.w};
#pragma unroll
    for (int b = 0; b < B; ++b) {
      bf16* hr = hs + b * hrow + c;
      float v8[8];
      smem_bf16x8(hr, v8);
      __align__(16) bf16 o8[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) o8[e] = f2bf(v8[e] * inv[b] * g[e]);
      *reinterpret_cast<uint4*>(hr) = *reinterpret_cast<const uint4*>(o8);
    }
  }
  __syncthreads();
}

// cp.async.wait_group for a count known at run time (≤ MAX_ST − 1)
DEVI void cp_async_wait_dyn(int n) {
  if (n >= 3) cp_async_wait<3>();
  else if (n == 2) cp_async_wait<2>();
  else if (n == 1) cp_async_wait<1>();
  else cp_async_wait<0>();
}

template <int B>
__global__ void __launch_bounds__(NT, 1)
fused_head_kernel(const bf16* __restrict__ x, const bf16* __restrict__ table,
                  const float* __restrict__ ln, int D, int V, int K, int ST,
                  float eps, float cap, float* __restrict__ part_v,
                  int* __restrict__ part_i, int* __restrict__ arrivals,
                  float* __restrict__ out_v, int* __restrict__ out_i) {
  const int C = (int)cooperative_groups::this_cluster().num_blocks();
  const int rank = blockIdx.x % C, g = blockIdx.x / C, G = gridDim.x / C;
  const Lay L{D, ST};
  const int hrow = L.hrow(), nc = L.dp() / KC;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gi = lane >> 2, ti = lane & 3;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  bf16* hs = reinterpret_cast<bf16*>(smem + L.hs());
  float* red = reinterpret_cast<float*>(smem + L.red());
  float* cv = reinterpret_cast<float*>(smem + L.cand());
  int* ci = reinterpret_cast<int*>(cv + BP * TOPK_MAXK);
  int* last = ci + BP * TOPK_MAXK;

  // this CTA's run [r0, r1): V / (G·C) rows, one more for the first
  // V % (G·C) CTAs, cut in RB-row blocks
  const int n = (int)gridDim.x, q = (int)blockIdx.x;
  const int per = V / n, extra = V % n;
  const int r0 = q * per + min(q, extra), r1 = r0 + per + (q < extra ? 1 : 0);
  const int T = (r1 - r0 + RB - 1) / RB * nc;     // stages: blocks × chunks

  // stage t: rows r0 + (t / nc)·RB + [0, RB), columns (t % nc)·KC + [0,
  // KC); thread tid loads the 16-byte pieces tid, tid + NT, … of the
  // stage in row order (a warp 512 contiguous bytes of a row); rows past
  // the run and columns past D are zero-filled
  auto load = [&](int t) {
    if (t >= T) return;
    bf16* dst = ring + (size_t)(t % ST) * RB * ARS;
    const int vb = r0 + (t / nc) * RB, cb = (t % nc) * KC;
#pragma unroll
    for (int j = 0; j < PIECES; ++j) {
      const int i = tid + j * NT, row = i / (KC / 8), p = (i % (KC / 8)) * 8;
      const int v = vb + row, col = cb + p;
      const bool ok = v < r1 && col < D;
      cp_async16_zfill(dst + row * ARS + p,
                       table + (ok ? (size_t)v * D + col : 0), ok ? 16 : 0);
    }
  };
  // x into h's rows first (its own commit group, ahead of the table's in
  // the memory system's queues), then the ring's first stages
  for (int b = 0; b < B; ++b)
    for (int c = tid * 8; c < D; c += NT * 8)
      cp_async16(hs + b * hrow + c, x + (size_t)b * D + c);
  cp_async_commit();
  for (int t = 0; t < ST - 1; ++t) {
    load(t);
    cp_async_commit();
  }

  // h: zero rows past B and columns past D (the MMA's padding), then the
  // rounded final norm, while the first stages load
  for (int b = 0; b < BP; ++b)
    for (int c = (b < B ? D : 0) + tid * 8; c < hrow; c += NT * 8)
      *reinterpret_cast<uint4*>(hs + b * hrow + c) = make_uint4(0u, 0u, 0u, 0u);
  cp_async_wait_dyn(ST - 1);           // x has landed
  __syncthreads();
  head_norm<B>(ln, D, eps, hs, hrow, red);

  LaneTopK top;
  top.init();
  float acc[RT][4];
#pragma unroll
  for (int j = 0; j < RT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  // ldmatrix A rows: lanes 0-15 rows 0-15 at k 0, lanes 16-31 at k 8
  const int arow = lane & 15, acol = (lane >> 4) * 8;
  for (int t = 0; t < T; ++t) {
    // stage t has landed, and no thread still reads the stage that
    // stage t + ST − 1 overwrites
    cp_async_wait_dyn(ST - 2);
    __syncthreads();
    load(t + ST - 1);
    cp_async_commit();
    const bf16* tile = ring + (size_t)(t % ST) * RB * ARS;
    const int c = t % nc;
#pragma unroll
    for (int s0 = 0; s0 < KW; s0 += KS) {
      float cc[RT][4];
#pragma unroll
      for (int j = 0; j < RT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) cc[j][e] = 0.f;
#pragma unroll
      for (int s = s0; s < s0 + KS; ++s) {
        const int k = (warp * KW + s) * 16;
        const bf16* hb = hs + gi * hrow + c * KC + k + ti * 2;
        const uint32_t b0 = lds32(hb), b1 = lds32(hb + 8);
#pragma unroll
        for (int j = 0; j < RT; ++j) {
          uint32_t a[4];
          ldsm_x4(tile + (j * 16 + arow) * ARS + k + acol, a);
          mma_bf16(cc[j], a, b0, b1);
        }
      }
#pragma unroll
      for (int j = 0; j < RT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += cc[j][e];
    }
    if (c != nc - 1) continue;

    // the block's last chunk: this warp's partial logits to red[warp][slot]
    // [row] (C fragment: rows gi, gi + 8 of a tile, slots 2·ti, 2·ti + 1)
    float* rw = red + warp * BP * RRS;
#pragma unroll
    for (int j = 0; j < RT; ++j) {
      const int row = j * 16 + gi;
      rw[(2 * ti) * RRS + row] = acc[j][0];
      rw[(2 * ti + 1) * RRS + row] = acc[j][1];
      rw[(2 * ti) * RRS + row + 8] = acc[j][2];
      rw[(2 * ti + 1) * RRS + row + 8] = acc[j][3];
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    }
    __syncthreads();
    // warp s: slot s's logits, the warps' partials added in warp order;
    // red is written again only after the next stage's barrier
    if (warp < B) {
      const int vb = r0 + (t / nc) * RB;
#pragma unroll
      for (int row = lane; row < RB; row += 32) {
        float l = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) l += red[(w * BP + warp) * RRS + row];
        if (cap > 0.f) l = tanhf(l / cap) * cap;
        if (vb + row < r1) top.insert(l, vb + row);
      }
    }
  }
  cp_async_wait<0>();

  // the run's K best per slot, then the cluster's, over DSMEM
  if (warp < B)
    warp_topk_write(top, K, cv + warp * TOPK_MAXK, ci + warp * TOPK_MAXK);
  cluster::topk(cv, ci, B, K, TOPK_MAXK, [&](int s, float*& ov, int*& oi) {
    ov = part_v + ((size_t)g * B + s) * K;
    oi = part_i + ((size_t)g * B + s) * K;
  });

  // the last cluster to arrive at this rank's counter merges the G
  // clusters' candidates of this rank's slots
  cluster::last_arrival(arrivals + rank, G, last, [&] {
    for (int s = rank + C * warp; s < B; s += C * NW) {
      LaneTopK t;
      t.init();
      // four candidates a lane in flight at once, then their selection
      for (int j0 = lane; j0 < G * K; j0 += 4 * 32) {
        float lv[4];
        int li[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j0 + 32 * e;
          const size_t at = ((size_t)(min(j, G * K - 1) / K) * B + s) * K
              + min(j, G * K - 1) % K;
          lv[e] = __ldcg(part_v + at);
          li[e] = __ldcg(part_i + at);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j0 + 32 * e < G * K) t.insert(lv[e], li[e]);
      }
      warp_topk_write(t, K, out_v + (size_t)s * K, out_i + (size_t)s * K);
    }
  });
}

template <int B>
int launch(int G, int C, const bf16* x, const bf16* table, const float* ln,
           float* part_v, int* part_i, int* arrivals, float* out_v, int* out_i,
           int D, int V, int K, float eps, float cap, cudaStream_t stream) {
  const int st = stages(D);
  if (!st) return (int)cudaErrorInvalidValue;
  return (int)cluster::launch(fused_head_kernel<B>, dim3(G * C), NT,
                              Lay{D, st}.total(), stream, C, x, table, ln, D,
                              V, K, st, eps, cap, part_v, part_i, arrivals,
                              out_v, out_i);
}

}  // namespace

// x [B, D] bf16, table [V, D] bf16, ln [D] f32; part_v / part_i [G, B, K]
// (the clusters' candidates), arrivals ≥ C int32 zeros (left at zero);
// out_v / out_i [B, K]; cap 0: no logit softcap.  Every CTA of the G·C
// owns at least one row (the wrapper's cluster_plan gives each at least
// 16).
extern "C" int fused_head_launch(const void* x, const void* table,
                                 const void* ln, void* part_v, void* part_i,
                                 void* arrivals, void* out_v, void* out_i,
                                 int B, int D, int V, int K, int G, int C,
                                 float eps, float cap, void* stream) {
  if (D % 8 != 0 || K < 1 || K > TOPK_MAXK || G < 1 || C < 1 ||
      G * C > (V + 15) / 16)
    return (int)cudaErrorInvalidValue;
#define ARGS G, C, (const bf16*)x, (const bf16*)table, (const float*)ln, \
    (float*)part_v, (int*)part_i, (int*)arrivals, (float*)out_v, (int*)out_i, \
    D, V, K, eps, cap, (cudaStream_t)stream
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
