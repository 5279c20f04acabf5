// B2 — fused block tail: r = x + a (a first normed by post_ln1 where
// given: Gemma-2), h = RMSNorm(r, ln2), the FFN (gated act(h·Wg)·(h·Wi),
// or ungated act(h·Wi)), second residual add.  One device launch.
//
// Replaces repro/kernels/fused_ffn/fused_ffn.py:fused_ffn_block (the
// Pallas kernel at its pallas_call, line 153), with or without post_ln1,
// gated or ungated, with the reference's activations (silu, gelu =
// gelu_tanh, relu, relu2) as a template parameter.
//
// Bound on an H100: bytes — w_in, w_gate and w_out (270.5 MB at
// Llama2-7B, 352 MB at Granite-8B, 1019 MB at Gemma-2 27B, 1453 MB at
// Qwen2-72B; w_in and w_out, 113 MB, ungated at Minitron-4B) are read
// once per step for all B
// slots, at 2·B FLOPs per weight element.  Design, the paper's cluster
// split: G thread-block clusters of C CTAs (the wrapper's plan: 15
// clusters of 8, 120 CTAs, at every served width: as many as an H100
// runs at once with one CTA an SM; a 16th would share SMs and hold the
// launch back).  Cluster g owns a contiguous slice of d_ff (whole units
// of 16 columns), which it takes in chunks of at most MAX_UNITS units
// (one chunk up to Granite-8B's 60 units a cluster, three of at most 52 at
// Gemma-2 27B's 153-154), and rank r of it rows [r·D/C, (r+1)·D/C) of
// d_model.  Rank r of cluster g
//   1. computes, with post_ln1, the sums of squares of a on its rows,
//      summed over the cluster in rank order (cluster::sum), and a' =
//      bf16(rms(a, post_ln1)) on its rows (else a' = a); then r =
//      bf16(x + a') and its sums of squares, summed the same way, and
//      keeps h = bf16(rms(r, ln2)) of its rows in shared memory for all
//      the chunks;
//   then, chunk by chunk:
//   2. streams its rows of the chunk's w_in columns, then (gated) of its
//      w_gate columns, ONCE through a 4-stage cp.async ring and
//      multiplies them on the tensor cores (mma.sync m16n8k16: the weight
//      tile as A, loaded with ldmatrix .trans, the B ≤ 8 slots on n, so
//      no MMA row is padding);
//   3. ClusterReduce: the [F_k, 8] f32 u partials (gated: u|g, [F_k, 2,
//      8]) are summed in rank order over DSMEM, each rank its own columns
//      (cluster::sum), which it rounds — u, g and hm = bf16(act(g)·u), or
//      hm = bf16(act(u)) ungated: the reference's rounding points — and
//      gathers as bf16 (cluster::gather);
//   4. streams the chunk's w_out rows, columns [r·D/C, (r+1)·D/C), through
//      a 5-stage ring (its first two tiles load during step 3) and
//      multiplies hm by them on the tensor cores, adding to the cluster's
//      [B, D] partial of the down projection held in registers over the
//      chunks, each rank its own columns, with no further reduction on
//      chip;
//   5. writes that partial to ws[g] (f32 [G, B, D]) and bumps the arrival
//      counter of its column slice (cluster::last_arrival); the LAST of the
//      G clusters to arrive at a slice sums the G partials in cluster
//      order 0..G−1 (sixteen loads of a column group in flight), adds
//      add_r·r (r recomputed from x, a and the rank's post_ln1 factors),
//      rounds once, writes o and r there, and resets the counter for the
//      next call.
// Every weight byte is read once for the grid; partials are summed in a
// fixed order, with no float atomics and no host work inside a call.
#include "cluster.cuh"

namespace {

constexpr int NT = 256;        // 8 warps
constexpr int NW = NT / 32;
constexpr int BP = 8;          // slots as laid out: the MMA's n
constexpr int TK = 16;         // weight rows a tile: one k16 step
constexpr int UST = 4;         // w_in / w_gate ring stages
constexpr int DST = 5;         // w_out ring stages (two load before step 3)
// down m tiles a warp (a template parameter, DT): 5 where D / C ≤ 640
// (every served width up to Gemma-2 27B's 4608 / 8 = 576), 8 up to 1024
// (Qwen2-72B's 8192 / 8), for the gated silu FFN only (the one registered
// model that wide); the 8 instances hold 12 more accumulators a thread,
// which cost the 640-row plans up to 3 % a call (PERF.md §6)
constexpr int NARROW_DT = 5;
constexpr int MAX_DT = 8;
// u|g m tiles a warp (a template parameter): 6 where a chunk holds at
// most 48 16-column units (Llama2-7B's, DeepSeek-V2-Lite's and
// Minitron-4B's plans), 8 up to 64 units (Granite-8B's d_ff 14336 in one
// chunk, Gemma-2 27B's 36864 in three a cluster)
constexpr int MAX_UNITS = NW * 8;

// The reference's activations (repro/models/layers.py:activation; gelu is
// jax.nn.gelu's default, the tanh approximation), in f32.
enum Act { SILU = 0, GELU_TANH = 1, RELU = 2, RELU2 = 3 };

template <int ACT>
DEVI float act_f32(float v) {
  if constexpr (ACT == SILU) {
    return v * (1.0f / (1.0f + expf(-v)));
  } else if constexpr (ACT == GELU_TANH) {
    const float c = 0.7978845608028654f;   // sqrt(2 / pi)
    return v * (0.5f * (1.0f + tanhf(c * (v + 0.044715f * (v * v * v)))));
  } else if constexpr (ACT == RELU) {
    return fmaxf(v, 0.f);
  } else {
    const float r = fmaxf(v, 0.f);
    return r * r;
  }
}

__host__ __device__ constexpr size_t smax(size_t a, size_t b) {
  return a > b ? a : b;
}

// Shared-memory layout for Dr = D / C rows a rank, chunks of at most Fm
// columns, C ranks, NPC partial floats a column (u for 8 slots, then g
// for 8 when gated), and the EXT instances' own region for h.
struct Lay {
  int Dr, Fm, C, NPC;
  bool ext;
  __host__ __device__ int urow() const { return Fm + 8; }   // bf16, padded
  __host__ __device__ int drow() const { return Dr + 8; }   // bf16, padded
  __host__ __device__ size_t up_stage() const { return (size_t)TK * urow() * 2; }
  __host__ __device__ size_t dn_stage() const { return (size_t)TK * drow() * 2; }
  // the u|g partials f32 [Fm][NPC], after the first two w_out tiles
  __host__ __device__ size_t part() const { return 2 * dn_stage(); }
  // region 0, reused phase by phase: the up ring; the first two w_out
  // tiles and the partials; the w_out ring; the output staging
  // f32 [BP][Dr + 4]
  __host__ __device__ size_t r0() const {
    size_t s = UST * up_stage();
    s = smax(s, part() + (size_t)Fm * NPC * 4);
    s = smax(s, DST * dn_stage());
    return smax(s, (size_t)BP * (Dr + 4) * 4);
  }
  // region 1: this rank's rows of h, bf16 [BP][Dr + 8]; a chunk's
  // reduced u|g f32 [Fm / C][NPC] and its hm bf16 [Fm][BP] over them
  // after step 2, or (EXT: h kept for every chunk) beside them
  __host__ __device__ size_t hs() const { return r0(); }
  __host__ __device__ size_t red() const {
    return hs() + (ext ? (size_t)BP * drow() * 2 : 0);
  }
  __host__ __device__ size_t hm() const {
    return red() + (size_t)(Fm / C) * NPC * 4;
  }
  __host__ __device__ size_t misc() const {
    return smax(hs() + (size_t)BP * drow() * 2, hm() + (size_t)Fm * BP * 2);
  }
  // misc: red_ss [NW·BP], the rank's and the cluster's sums of squares
  // ssp ssa [BP], inv [BP], post_ln1's inva [BP], the last-arrival flag
  // (padded to BP), then ln2's rows [Dr]
  __host__ __device__ size_t ln2s() const {
    return misc() + (size_t)(NW * BP + 5 * BP) * 4;
  }
  __host__ __device__ size_t total() const { return ln2s() + (size_t)Dr * 4; }
};

// One CTA an SM (the grid is one wave of them): the gated MUT 8
// instance's 64 u|g accumulators a thread need more than 128 registers;
// MUT 6, given them too, ran 0-3 % faster than capped at 128.
// BT: the slots as a constant (8, the served batch), or 0 to take them
// from B_ (fewer slots).  EXT (with MUT 8): post_ln1, and a d_ff slice
// in chunks, the down projection's partial held in registers over them
// (Gemma-2 27B); without it the instance takes one chunk and no
// post_ln1, and its code stays as small as before they were added (with
// them every instance's B2 ran 3-5 % slower inside a decode step,
// PERF.md §6).  DT: the down projection's m tiles a warp, 5 for at most
// 640 rows a rank, 8 for up to 1024 (Qwen2-72B).
template <bool GATED, int ACT, int MUT, int BT, bool EXT, int DT>
__global__ void __launch_bounds__(NT, 1)
fused_ffn_kernel(const bf16* __restrict__ x, const bf16* __restrict__ a,
                 const bf16* __restrict__ w_in, const bf16* __restrict__ w_gate,
                 const bf16* __restrict__ w_out, const float* __restrict__ ln2,
                 const float* __restrict__ post1, float* __restrict__ ws,
                 int* __restrict__ arrivals, bf16* __restrict__ o,
                 bf16* __restrict__ r_out, int B_, int D, int F, int Fm,
                 float eps, float add_r) {
  const int B = BT ? BT : B_;
  constexpr int NPC = GATED ? 2 * BP : BP;   // partial floats a column
  const int C = (int)cooperative_groups::this_cluster().num_blocks();
  const int rank = blockIdx.x % C, g = blockIdx.x / C, G = gridDim.x / C;
  const Lay L{D / C, Fm, C, NPC, EXT};
  const int Dr = L.Dr, d0 = rank * Dr, urow = L.urow(), drow = L.drow();
  // cluster g's slice of d_ff: [f0, f0 + Fg), whole 16-column units, in
  // chunks [f0 + k·Fm, f0 + k·Fm + Fk) of Fk = min(Fm, Fg − k·Fm) columns
  const int units = F / 16, per = units / G, extra = units % G;
  const int Fg = 16 * (per + (g < extra ? 1 : 0));
  const int f0 = 16 * (g * per + min(g, extra));
  const int nch = EXT ? (Fg + Fm - 1) / Fm : 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gi = lane >> 2, ti = lane & 3;
  // ldmatrix .trans of an A tile stored [k][m]: lanes 0-7 give rows k 0-7
  // at m 0, 8-15 rows k 0-7 at m 8, 16-23 rows k 8-15 at m 0, 24-31 rows
  // k 8-15 at m 8 (a0 a1 a2 a3 of m16n8k16)
  const int ak = (lane & 7) + ((lane >> 4) << 3), am = ((lane >> 3) & 1) << 3;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  float* part = reinterpret_cast<float*>(smem + L.part());
  float* stage_o = reinterpret_cast<float*>(smem);
  bf16* hs = reinterpret_cast<bf16*>(smem + L.hs());
  float* red = reinterpret_cast<float*>(smem + L.red());
  bf16* hm = reinterpret_cast<bf16*>(smem + L.hm());
  float* red_ss = reinterpret_cast<float*>(smem + L.misc());
  float* ssp = red_ss + NW * BP;
  float* ssa = ssp + BP;
  float* inv = ssa + BP;
  float* inva = inv + BP;
  int* last = reinterpret_cast<int*>(inva + BP);
  float* ln2s = reinterpret_cast<float*>(smem + L.ln2s());

  // the w_in tiles of a chunk, then (gated) its w_gate tiles
  const int nk = Dr / TK, nup = GATED ? 2 * nk : nk;
  int fc0 = f0, Fk = min(Fm, Fg);       // the chunk in hand
  auto load_up = [&](int t) {
    bf16* dst = ring + (size_t)(t % UST) * TK * urow;
    const bf16* w = t < nk ? w_in : w_gate;
    const int rb = d0 + (t % nk) * TK, c8 = Fk / 8;
    for (int i = tid; i < TK * c8; i += NT) {
      const int p = i / c8, j = (i % c8) * 8;
      cp_async16(dst + p * urow + j, w + (size_t)(rb + p) * F + fc0 + j);
    }
  };
  auto up_prologue = [&] {
#pragma unroll
    for (int t = 0; t < UST - 1; ++t) {
      if (t < nup) load_up(t);
      cp_async_commit();
    }
  };

  // ---- prologue: ln2's rows (a commit group of their own), then the
  // first chunk's first w_in tiles, all in flight at once
  for (int i = tid; i < Dr / 4; i += NT) cp_async16(ln2s + i * 4, ln2 + d0 + i * 4);
  cp_async_commit();
  up_prologue();

  // ---- step 1: a' = bf16(rms(a, post_ln1)) (or a), r = bf16(x + a') and
  // its sums of squares on this rank's rows, summed over the cluster in
  // rank order; h = bf16(rms(r, ln2)) --------------------------------------
  // the slots' sums of squares of this rank's rows (ss[b], b < B) summed
  // over the warps, then over the cluster's ranks, into 1/rms: out[b]
  auto rms_inv = [&](float (&ss)[BP], float* out) {
#pragma unroll
    for (int b = 0; b < BP; ++b) {
      if (b < B) {
        const float s = warp_sum(ss[b]);
        if (lane == 0) red_ss[warp * BP + b] = s;
      }
    }
    __syncthreads();
    if (tid < BP) {
      float s = 0.f;
      if (tid < B)
        for (int w = 0; w < NW; ++w) s += red_ss[w * BP + tid];
      ssp[tid] = s;
    }
    cluster::sum(ssp, ssa, 0, BP);
    if (tid < B) out[tid] = 1.0f / sqrtf(ssa[tid] / (float)D + eps);
    __syncthreads();
  };
  {
    float ss[BP];
    if (EXT && post1 != nullptr) {
#pragma unroll
      for (int b = 0; b < BP; ++b) ss[b] = 0.f;
      for (int i = tid; i < Dr / 8; i += NT) {
#pragma unroll
        for (int b = 0; b < BP; ++b) {
          if (b < B) {
            float av[8];
            load_bf16x8(a + (size_t)b * D + d0 + i * 8, av);
#pragma unroll
            for (int k = 0; k < 8; ++k) ss[b] += av[k] * av[k];
          }
        }
      }
      rms_inv(ss, inva);
    }
#pragma unroll
    for (int b = 0; b < BP; ++b) ss[b] = 0.f;
    for (int i = tid; i < Dr / 8; i += NT) {
      float p1[8];
      if (EXT && post1 != nullptr) {
        const float4 pa = __ldg(reinterpret_cast<const float4*>(post1 + d0 + i * 8));
        const float4 pb = __ldg(reinterpret_cast<const float4*>(post1 + d0 + i * 8) + 1);
        p1[0] = pa.x; p1[1] = pa.y; p1[2] = pa.z; p1[3] = pa.w;
        p1[4] = pb.x; p1[5] = pb.y; p1[6] = pb.z; p1[7] = pb.w;
      }
#pragma unroll
      for (int b = 0; b < BP; ++b) {
        if (b < B) {
          float xv[8], av[8];
          load_bf16x8(x + (size_t)b * D + d0 + i * 8, xv);
          load_bf16x8(a + (size_t)b * D + d0 + i * 8, av);
          __align__(16) bf16 r8[8];
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const float ak_ = EXT && post1 != nullptr
                ? round_bf(av[k] * inva[b] * (1.0f + p1[k])) : av[k];
            const float v = round_bf(xv[k] + ak_);
            ss[b] += v * v;
            r8[k] = f2bf(v);
          }
          *reinterpret_cast<uint4*>(hs + b * drow + i * 8) =
              *reinterpret_cast<const uint4*>(r8);
        }
      }
    }
    rms_inv(ss, inv);
    cp_async_wait<UST - 1>();       // ln2's rows have landed
    __syncthreads();
    // eight values a step; slots past B zero (the MMA's n columns)
    for (int i = tid; i < BP * (Dr / 8); i += NT) {
      const int b = i / (Dr / 8), c = (i % (Dr / 8)) * 8;
      bf16* hr = hs + b * drow + c;
      if (b >= B) {
        *reinterpret_cast<uint4*>(hr) = make_uint4(0u, 0u, 0u, 0u);
        continue;
      }
      float v8[8];
      smem_bf16x8(hr, v8);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        hr[k] = f2bf(v8[k] * inv[b] * (1.0f + ln2s[c + k]));
    }
  }

  // the cluster's partial of the down projection, over every chunk:
  // warp w holds output m tiles (16 columns) w, w + 8, …
  const int ndm = Dr / 16;
  float cd[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) cd[j][q] = 0.f;

  for (int ck = 0; ck < nch; ++ck) {
    if (ck > 0) {
      // the next chunk: the ring is free (the last down tile was waited
      // for and every thread passed the barrier after it)
      fc0 = f0 + ck * Fm;
      Fk = min(Fm, Fg - ck * Fm);
      up_prologue();
    }
    // ---- step 2: u (and g) over this rank's rows ------------------------
    // warp w: m tiles (16 columns of the chunk) w, w + 8, …; A = the
    // weight tile (ldmatrix .trans), B = h (k pairs of one slot a lane)
    const int nut = Fk / 16;
    float cu[MUT][4], cg_[GATED ? MUT : 1][4];
#pragma unroll
    for (int j = 0; j < MUT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) cu[j][q] = 0.f;
    if constexpr (GATED) {
#pragma unroll
      for (int j = 0; j < MUT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) cg_[j][q] = 0.f;
    }
    auto mma_up = [&](const bf16* tile, uint32_t b0, uint32_t b1,
                      float (&acc)[MUT][4]) {
#pragma unroll
      for (int j = 0; j < MUT; ++j) {
        const int mt = warp + j * NW;
        if (mt < nut) {
          uint32_t af[4];
          ldsm_x4_t(tile + ak * urow + mt * 16 + am, af);
          mma_bf16(acc[j], af, b0, b1);
        }
      }
    };
    for (int t = 0; t < nup; ++t) {
      // tile t has landed, and no thread still reads the stage that tile
      // t + UST - 1 overwrites
      cp_async_wait<UST - 2>();
      __syncthreads();
      if (t + UST - 1 < nup) load_up(t + UST - 1);
      cp_async_commit();
      const bf16* tile = ring + (size_t)(t % UST) * TK * urow;
      const bf16* hb = hs + gi * drow + (t % nk) * TK + ti * 2;
      const uint32_t b0 = lds32(hb), b1 = lds32(hb + 8);
      if constexpr (GATED) {
        if (t < nk) mma_up(tile, b0, b1, cu);
        else mma_up(tile, b0, b1, cg_);
      } else {
        mma_up(tile, b0, b1, cu);
      }
    }
    cp_async_wait<0>();
    __syncthreads();

    // the chunk's first two w_out tiles go in flight while u|g are reduced
    const int ndt = Fk / TK;
    const bf16* wo = w_out + (size_t)fc0 * D + d0;
    auto load_dn = [&](int t) {
      if (t >= ndt) return;
      bf16* dst = ring + (size_t)(t % DST) * TK * drow;
      for (int i = tid; i < TK * (Dr / 8); i += NT) {
        const int p = i / (Dr / 8), j = (i % (Dr / 8)) * 8;
        cp_async16(dst + p * drow + j, wo + (size_t)(t * TK + p) * D + j);
      }
    };
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      load_dn(t);
      cp_async_commit();
    }

    // this rank's partials as part[f][u 0..7 | g 0..7]
#pragma unroll
    for (int j = 0; j < MUT; ++j) {
      const int mt = warp + j * NW;
      if (mt < nut) {
        float* p0 = part + (size_t)(mt * 16 + gi) * NPC + ti * 2;
        float* p1 = p0 + 8 * NPC;
        *reinterpret_cast<float2*>(p0) = make_float2(cu[j][0], cu[j][1]);
        *reinterpret_cast<float2*>(p1) = make_float2(cu[j][2], cu[j][3]);
        if constexpr (GATED) {
          *reinterpret_cast<float2*>(p0 + BP) = make_float2(cg_[j][0], cg_[j][1]);
          *reinterpret_cast<float2*>(p1 + BP) = make_float2(cg_[j][2], cg_[j][3]);
        }
      }
    }
    // ClusterReduce: rank r sums columns [r·Fk/C, (r+1)·Fk/C) in rank
    // order (cluster::sum writes out[i] for i in the range, so `red` is
    // passed shifted back by the range's start), rounds them to hm, and
    // the ranks gather hm
    const int fr = Fk / C, fb = rank * fr;
    cluster::sum(part, red - (size_t)fb * NPC, fb * NPC, (fb + fr) * NPC);
    for (int i = tid; i < fr * BP; i += NT) {
      const int f = i / BP, b = i % BP;
      const float u = round_bf(red[f * NPC + b]);
      if constexpr (GATED) {
        const float gv = round_bf(red[f * NPC + BP + b]);
        hm[(fb + f) * BP + b] = f2bf(act_f32<ACT>(gv) * u);
      } else {
        hm[(fb + f) * BP + b] = f2bf(act_f32<ACT>(u));
      }
    }
    // hm is [Fk][BP] bf16: a rank's columns are fr·BP/2 floats
    cluster::gather(reinterpret_cast<float*>(hm), fr * BP / 2);

    // ---- step 4: out[:, d0 + :Dr] += hm · w_out[chunk rows, d0 + :Dr] --
    // A = the w_out tile (ldmatrix .trans), B = hm (ldmatrix .trans of
    // [f][slot] rows)
    for (int t = 2; t < DST - 1; ++t) {
      load_dn(t);
      cp_async_commit();
    }
    for (int t = 0; t < ndt; ++t) {
      cp_async_wait<DST - 2>();
      __syncthreads();
      load_dn(t + DST - 1);
      cp_async_commit();
      const bf16* tile = ring + (size_t)(t % DST) * TK * drow;
      uint32_t bq[2];
      ldsm_x2_t(hm + (size_t)(t * TK + (lane & 15)) * BP, bq);
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        const int mt = warp + j * NW;
        if (mt < ndm) {
          uint32_t af[4];
          ldsm_x4_t(tile + ak * drow + mt * 16 + am, af);
          mma_bf16(cd[j], af, bq[0], bq[1]);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();
  }

  // ---- step 5: the cluster's partial to ws[g]; the last cluster sums ---
  const int srow = Dr + 4;     // staging row (f32): conflict-free stores
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int mt = warp + j * NW;
    if (mt < ndm) {
      const int c = mt * 16 + gi;
      stage_o[(2 * ti) * srow + c] = cd[j][0];
      stage_o[(2 * ti + 1) * srow + c] = cd[j][1];
      stage_o[(2 * ti) * srow + c + 8] = cd[j][2];
      stage_o[(2 * ti + 1) * srow + c + 8] = cd[j][3];
    }
  }
  __syncthreads();
  const int q4 = Dr / 4;
  for (int i = tid; i < B * q4; i += NT) {
    const int b = i / q4, c = (i % q4) * 4;
    *reinterpret_cast<float4*>(ws + ((size_t)g * B + b) * D + d0 + c) =
        *reinterpret_cast<const float4*>(stage_o + b * srow + c);
  }
  // the last cluster to arrive at this column slice's counter sums the
  // G clusters' partials of its columns
  cluster::last_arrival(arrivals + rank, G, last, [&] {
    // sixteen partials of a column group in flight at once (the index
    // clamped, the sum predicated), summed in cluster order
    constexpr int KB = 16;
    for (int i = tid; i < B * q4; i += NT) {
      const int b = i / q4, c = d0 + (i % q4) * 4;
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int k0 = 0; k0 < G; k0 += KB) {
        float4 v[KB];
#pragma unroll
        for (int u = 0; u < KB; ++u)
          v[u] = __ldcg(reinterpret_cast<const float4*>(
              ws + ((size_t)min(k0 + u, G - 1) * B + b) * D + c));
#pragma unroll
        for (int u = 0; u < KB; ++u) {
          if (k0 + u < G) {
            s.x += v[u].x; s.y += v[u].y; s.z += v[u].z; s.w += v[u].w;
          }
        }
      }
      float xv[4], av[4];
      load_bf16x4(x + (size_t)b * D + c, xv);
      load_bf16x4(a + (size_t)b * D + c, av);
      if (EXT && post1 != nullptr) {
        const float4 p = __ldg(reinterpret_cast<const float4*>(post1 + c));
        const float p4[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) av[k] = round_bf(av[k] * inva[b] * (1.0f + p4[k]));
      }
      const float sv[4] = {s.x, s.y, s.z, s.w};
      __align__(8) bf16 o4[4], r4[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float rv = round_bf(xv[k] + av[k]);
        o4[k] = f2bf(sv[k] + rv * add_r);
        r4[k] = f2bf(rv);
      }
      *reinterpret_cast<uint2*>(o + (size_t)b * D + c) =
          *reinterpret_cast<const uint2*>(o4);
      *reinterpret_cast<uint2*>(r_out + (size_t)b * D + c) =
          *reinterpret_cast<const uint2*>(r4);
    }
  });
}

// What the kernel takes (the wrapper's cluster_plan keeps to it): D / C
// rows a rank, a multiple of 16 up to 1024 (Qwen2-72B's 8192 over 8);
// d_ff a multiple of 16, cut
// into G slices of at least one 16-column unit each; 1 ≤ B ≤ 8 slots.
bool plan_ok(int B, int D, int F, int G, int C) {
  if (B < 1 || B > BP || C < 1 || C > 8 || G < 1 || D % C) return false;
  const int Dr = D / C, units = F / 16;
  return Dr % 16 == 0 && Dr <= 16 * NW * MAX_DT && F % 16 == 0 &&
         units >= G;
}

// The chunk a cluster's slice goes in: the widest slice's U units cut
// into the fewest chunks of at most MAX_UNITS, as even as whole units
// allow (U itself where U ≤ MAX_UNITS: one chunk).
int chunk_cols(int F, int G) {
  const int U = (F / 16 + G - 1) / G, n = (U + MAX_UNITS - 1) / MAX_UNITS;
  return 16 * ((U + n - 1) / n);
}

// The instance for the chunking (EXT, MUT) and the slots (BT) of a
// launch, with DT down tiles a warp
template <bool GATED, int ACT, int DT>
auto pick(bool ext, int U, int B) {
  return ext
      ? (B == BP ? fused_ffn_kernel<GATED, ACT, 8, BP, true, DT>
                 : fused_ffn_kernel<GATED, ACT, 8, 0, true, DT>)
      : U <= NW * 6
      ? (B == BP ? fused_ffn_kernel<GATED, ACT, 6, BP, false, DT>
                 : fused_ffn_kernel<GATED, ACT, 6, 0, false, DT>)
      : (B == BP ? fused_ffn_kernel<GATED, ACT, 8, BP, false, DT>
                 : fused_ffn_kernel<GATED, ACT, 8, 0, false, DT>);
}

template <bool GATED, int ACT>
int launch(int B, int G, int C, const bf16* x, const bf16* a,
           const bf16* w_in, const bf16* w_gate, const bf16* w_out,
           const float* ln2, const float* post1, float* ws, int* arrivals,
           bf16* o, bf16* r, int D, int F, float eps, float add_r,
           cudaStream_t stream) {
  // EXT (MUT 8) with post_ln1 or where the widest slice takes chunks;
  // else one chunk: MUT 6 up to 48 units, MUT 8 up to 64
  const int U = (F / 16 + G - 1) / G, Fm = chunk_cols(F, G);
  const bool ext = post1 != nullptr || U > MAX_UNITS;
  const Lay L{D / C, Fm, C, GATED ? 2 * BP : BP, ext};
  auto kernel = pick<GATED, ACT, NARROW_DT>(ext, U, B);
  if (D / C > 16 * NW * NARROW_DT) {
    if constexpr (GATED && ACT == SILU)
      kernel = pick<GATED, ACT, MAX_DT>(ext, U, B);
    else
      return (int)cudaErrorInvalidValue;
  }
  return (int)cluster::launch(kernel, dim3(G * C), NT, L.total(), stream, C,
                              x, a, w_in, w_gate, w_out, ln2, post1, ws,
                              arrivals, o, r, B, D, F, Fm, eps, add_r);
}

}  // namespace

// act: 0 silu, 1 gelu_tanh (= the reference's gelu), 2 relu, 3 relu2;
// gated 0: w_gate is not read (may be null); post_ln1 null: no
// post-attention norm.
extern "C" int fused_ffn_launch(const void* x, const void* a, const void* w_in,
                                const void* w_gate, const void* w_out,
                                const void* ln2, const void* post_ln1,
                                void* ws, void* arrivals, void* o, void* r,
                                int B, int D, int F, int G,
                                int C, int act, int gated, float eps,
                                float add_r, void* stream) {
  if (!plan_ok(B, D, F, G, C) || act < SILU || act > RELU2)
    return (int)cudaErrorInvalidValue;
#define ARGS B, G, C, (const bf16*)x, (const bf16*)a, (const bf16*)w_in,          \
    (const bf16*)w_gate, (const bf16*)w_out, (const float*)ln2,                  \
    (const float*)post_ln1, (float*)ws, (int*)arrivals, (bf16*)o, (bf16*)r, D, \
    F, eps, add_r, (cudaStream_t)stream
  switch (act + 4 * (gated != 0)) {
    case SILU: return launch<false, SILU>(ARGS);
    case GELU_TANH: return launch<false, GELU_TANH>(ARGS);
    case RELU: return launch<false, RELU>(ARGS);
    case RELU2: return launch<false, RELU2>(ARGS);
    case 4 + SILU: return launch<true, SILU>(ARGS);
    case 4 + GELU_TANH: return launch<true, GELU_TANH>(ARGS);
    case 4 + RELU: return launch<true, RELU>(ARGS);
    default: return launch<true, RELU2>(ARGS);
  }
#undef ARGS
}
