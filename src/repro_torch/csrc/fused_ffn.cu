// B2 — fused block tail: r = x + a, h = RMSNorm(r, ln2), gated SiLU FFN,
// second residual add.  One device launch.
//
// Replaces repro/kernels/fused_ffn/fused_ffn.py:fused_ffn_block (the
// Pallas kernel at its pallas_call, line 153) without post_ln1, gated
// SiLU.
//
// Bound on an H100: bytes — w_in, w_gate and w_out (270.5 MB at
// Llama2-7B) are read once per step for all B slots, at 2·B FLOPs per
// weight element.  Design, the paper's cluster split: G thread-block
// clusters of C CTAs (the wrapper's plan: 15 clusters of 8, 120 CTAs, at
// Llama2-7B and DeepSeek-V2-Lite: as many as an H100 runs at once with
// one CTA an SM; a 16th would share SMs and hold the launch back).
// Cluster g owns a contiguous slice of d_ff (a multiple of 16 columns)
// and rank r of it rows [r·D/C, (r+1)·D/C) of d_model.  Rank r of
// cluster g
//   1. computes r = bf16(x + a) on its rows and their sums of squares,
//      summed over the cluster in rank order (cluster::sum), and keeps h
//      = bf16(rms(r, ln2)) of its rows in shared memory;
//   2. streams its rows of the slice's w_in columns, then of its w_gate
//      columns, ONCE through a 4-stage cp.async ring and multiplies them
//      on the tensor cores (mma.sync m16n8k16: the weight tile as A,
//      loaded with ldmatrix .trans, the B ≤ 8 slots on n, so no MMA row
//      is padding);
//   3. ClusterReduce: the [F_g, 2, 8] f32 u|g partials are summed in rank
//      order over DSMEM, each rank its own columns (cluster::sum), which
//      it rounds — u, g and hm = bf16(silu(g)·u), the reference's
//      rounding points — and gathers as bf16 (cluster::gather);
//   4. streams the slice's w_out rows, columns [r·D/C, (r+1)·D/C), through
//      a 5-stage ring (its first two tiles load during step 3) and
//      multiplies hm by them on the tensor cores: the cluster's [B, D]
//      partial of the down projection, each rank its own columns, with no
//      further reduction on chip;
//   5. writes that partial to ws[g] (f32 [G, B, D]) and bumps the arrival
//      counter of its column slice (cluster::last_arrival); the LAST of the
//      G clusters to arrive at a slice sums the G partials in cluster
//      order 0..G−1 (sixteen loads of a column group in flight), adds
//      add_r·r, rounds once, writes o and r there, and resets the counter
//      for the next call.
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
constexpr int MAX_UT = 6;      // u|g m tiles a warp: a slice ≤ 48·16 columns
constexpr int MAX_DT = 4;      // down m tiles a warp: D / C ≤ 512

__host__ __device__ constexpr size_t smax(size_t a, size_t b) {
  return a > b ? a : b;
}

// Shared-memory layout for Dr = D / C rows a rank, slices of at most Fm
// columns, C ranks.
struct Lay {
  int Dr, Fm, C;
  __host__ __device__ int urow() const { return Fm + 8; }   // bf16, padded
  __host__ __device__ int drow() const { return Dr + 8; }   // bf16, padded
  __host__ __device__ size_t up_stage() const { return (size_t)TK * urow() * 2; }
  __host__ __device__ size_t dn_stage() const { return (size_t)TK * drow() * 2; }
  // the u|g partials f32 [Fm][2·BP], after the first two w_out tiles
  __host__ __device__ size_t part() const { return 2 * dn_stage(); }
  // region 0, reused phase by phase: the up ring; the first two w_out
  // tiles and the partials; the w_out ring; the output staging
  // f32 [BP][Dr + 4]
  __host__ __device__ size_t r0() const {
    size_t s = UST * up_stage();
    s = smax(s, part() + (size_t)Fm * 2 * BP * 4);
    s = smax(s, DST * dn_stage());
    return smax(s, (size_t)BP * (Dr + 4) * 4);
  }
  // region 1: this rank's rows of h, bf16 [BP][Dr + 8]; after step 2 the
  // rank's reduced u|g f32 [Fm / C][2·BP], then hm bf16 [Fm][BP]
  __host__ __device__ size_t hs() const { return r0(); }
  __host__ __device__ size_t red() const { return hs(); }
  __host__ __device__ size_t hm() const {
    return red() + (size_t)(Fm / C) * 2 * BP * 4;
  }
  __host__ __device__ size_t misc() const {
    return hs() + smax((size_t)BP * drow() * 2,
                       hm() - hs() + (size_t)Fm * BP * 2);
  }
  // misc: red_ss [NW·BP], the rank's and the cluster's sums of squares
  // ssp ssa [BP], inv [BP], the last-arrival flag, then ln2's rows [Dr]
  __host__ __device__ size_t ln2s() const {
    return misc() + (size_t)(NW * BP + 4 * BP) * 4;
  }
  __host__ __device__ size_t total() const { return ln2s() + (size_t)Dr * 4; }
};

template <int B>
__global__ void __launch_bounds__(NT, 2)
fused_ffn_kernel(const bf16* __restrict__ x, const bf16* __restrict__ a,
                 const bf16* __restrict__ w_in, const bf16* __restrict__ w_gate,
                 const bf16* __restrict__ w_out, const float* __restrict__ ln2,
                 float* __restrict__ ws, int* __restrict__ arrivals,
                 bf16* __restrict__ o, bf16* __restrict__ r_out, int D, int F,
                 int Fm, float eps, float add_r) {
  const int C = (int)cooperative_groups::this_cluster().num_blocks();
  const int rank = blockIdx.x % C, g = blockIdx.x / C, G = gridDim.x / C;
  const Lay L{D / C, Fm, C};
  const int Dr = L.Dr, d0 = rank * Dr, urow = L.urow(), drow = L.drow();
  // cluster g's slice of d_ff: [f0, f0 + Fg), whole 16-column units
  const int units = F / 16, per = units / G, extra = units % G;
  const int Fg = 16 * (per + (g < extra ? 1 : 0));
  const int f0 = 16 * (g * per + min(g, extra));
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
  int* last = reinterpret_cast<int*>(inv + BP);
  float* ln2s = reinterpret_cast<float*>(smem + L.ln2s());

  // ---- prologue: ln2's rows (a commit group of their own), then the
  // first w_in tiles, all in flight at once
  for (int i = tid; i < Dr / 4; i += NT) cp_async16(ln2s + i * 4, ln2 + d0 + i * 4);
  cp_async_commit();
  const int nk = Dr / TK, nup = 2 * nk;     // w_in tiles, then w_gate's
  const int c8 = Fg / 8;
  auto load_up = [&](int t) {
    bf16* dst = ring + (size_t)(t % UST) * TK * urow;
    const bf16* w = t < nk ? w_in : w_gate;
    const int rb = d0 + (t % nk) * TK;
    for (int i = tid; i < TK * c8; i += NT) {
      const int p = i / c8, j = (i % c8) * 8;
      cp_async16(dst + p * urow + j, w + (size_t)(rb + p) * F + f0 + j);
    }
  };
#pragma unroll
  for (int t = 0; t < UST - 1; ++t) {
    if (t < nup) load_up(t);
    cp_async_commit();
  }

  // ---- step 1: r = bf16(x + a) and its sums of squares on this rank's
  // rows, summed over the cluster in rank order; h = bf16(rms(r, ln2)) --
  {
    float ss[B];
#pragma unroll
    for (int b = 0; b < B; ++b) ss[b] = 0.f;
    for (int i = tid; i < Dr / 8; i += NT) {
#pragma unroll
      for (int b = 0; b < B; ++b) {
        float xv[8], av[8];
        load_bf16x8(x + (size_t)b * D + d0 + i * 8, xv);
        load_bf16x8(a + (size_t)b * D + d0 + i * 8, av);
        __align__(16) bf16 r8[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float v = round_bf(xv[k] + av[k]);
          ss[b] += v * v;
          r8[k] = f2bf(v);
        }
        *reinterpret_cast<uint4*>(hs + b * drow + i * 8) =
            *reinterpret_cast<const uint4*>(r8);
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

  // ---- step 2: u|g over this rank's rows -------------------------------
  // warp w: m tiles (16 columns of the slice) w, w + 8, …; A = the weight
  // tile (ldmatrix .trans), B = h (k pairs of one slot a lane)
  const int nut = Fg / 16;
  float cu[MAX_UT][4], cg_[MAX_UT][4];
#pragma unroll
  for (int j = 0; j < MAX_UT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) { cu[j][q] = 0.f; cg_[j][q] = 0.f; }
  auto mma_up = [&](const bf16* tile, uint32_t b0, uint32_t b1,
                    float (&acc)[MAX_UT][4]) {
#pragma unroll
    for (int j = 0; j < MAX_UT; ++j) {
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
    if (t < nk) mma_up(tile, b0, b1, cu);
    else mma_up(tile, b0, b1, cg_);
  }
  cp_async_wait<0>();
  __syncthreads();

  // the first two w_out tiles go in flight while u|g are reduced
  const int ndt = Fg / TK;
  const bf16* wo = w_out + (size_t)f0 * D + d0;
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
  for (int j = 0; j < MAX_UT; ++j) {
    const int mt = warp + j * NW;
    if (mt < nut) {
      float* p0 = part + (size_t)(mt * 16 + gi) * 2 * BP + ti * 2;
      float* p1 = p0 + 8 * 2 * BP;
      *reinterpret_cast<float2*>(p0) = make_float2(cu[j][0], cu[j][1]);
      *reinterpret_cast<float2*>(p1) = make_float2(cu[j][2], cu[j][3]);
      *reinterpret_cast<float2*>(p0 + BP) = make_float2(cg_[j][0], cg_[j][1]);
      *reinterpret_cast<float2*>(p1 + BP) = make_float2(cg_[j][2], cg_[j][3]);
    }
  }
  // ClusterReduce: rank r sums columns [r·Fg/C, (r+1)·Fg/C) in rank order
  // (cluster::sum writes out[i] for i in the range, so `red` is passed
  // shifted back by the range's start), rounds them to hm, and the ranks
  // gather hm
  const int fr = Fg / C, fb = rank * fr;
  cluster::sum(part, red - (size_t)fb * 2 * BP, fb * 2 * BP, (fb + fr) * 2 * BP);
  for (int i = tid; i < fr * BP; i += NT) {
    const int f = i / BP, b = i % BP;
    const float u = round_bf(red[f * 2 * BP + b]);
    const float gv = round_bf(red[f * 2 * BP + BP + b]);
    const float act = gv * (1.0f / (1.0f + expf(-gv)));
    hm[(fb + f) * BP + b] = f2bf(act * u);
  }
  // hm is [Fg][BP] bf16: a rank's columns are fr·BP/2 floats
  cluster::gather(reinterpret_cast<float*>(hm), fr * BP / 2);

  // ---- step 4: out[:, d0 + :Dr] = hm · w_out[slice rows, d0 + :Dr] -----
  // warp w: m tiles (16 output columns) w, w + 8, …; A = the w_out tile
  // (ldmatrix .trans), B = hm (ldmatrix .trans of [f][slot] rows)
  for (int t = 2; t < DST - 1; ++t) {
    load_dn(t);
    cp_async_commit();
  }
  const int ndm = Dr / 16;
  float cd[MAX_DT][4];
#pragma unroll
  for (int j = 0; j < MAX_DT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) cd[j][q] = 0.f;
  for (int t = 0; t < ndt; ++t) {
    cp_async_wait<DST - 2>();
    __syncthreads();
    load_dn(t + DST - 1);
    cp_async_commit();
    const bf16* tile = ring + (size_t)(t % DST) * TK * drow;
    uint32_t bq[2];
    ldsm_x2_t(hm + (size_t)(t * TK + (lane & 15)) * BP, bq);
#pragma unroll
    for (int j = 0; j < MAX_DT; ++j) {
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

  // ---- step 5: the cluster's partial to ws[g]; the last cluster sums ---
  const int srow = Dr + 4;     // staging row (f32): conflict-free stores
#pragma unroll
  for (int j = 0; j < MAX_DT; ++j) {
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
// rows a rank, a multiple of 16 up to 512; d_ff a multiple of 16, cut
// into G slices of at most 736 columns (MAX_UT m tiles a warp), at least
// 16 each; B ≤ 8 slots.
bool plan_ok(int D, int F, int G, int C) {
  if (C < 1 || G < 1 || D % C) return false;
  const int Dr = D / C, units = F / 16;
  return Dr % 16 == 0 && Dr <= 16 * NW * MAX_DT && F % 16 == 0 &&
         units >= G && (units + G - 1) / G <= 46;
}

template <int B>
int launch(int G, int C, const bf16* x, const bf16* a, const bf16* w_in,
           const bf16* w_gate, const bf16* w_out, const float* ln2, float* ws,
           int* arrivals, bf16* o, bf16* r, int D, int F, float eps,
           float add_r, cudaStream_t stream) {
  const int units = F / 16, Fm = 16 * ((units + G - 1) / G);
  const Lay L{D / C, Fm, C};
  return (int)cluster::launch(fused_ffn_kernel<B>, dim3(G * C), NT, L.total(),
                              stream, C, x, a, w_in, w_gate, w_out, ln2, ws,
                              arrivals, o, r, D, F, Fm, eps, add_r);
}

}  // namespace

extern "C" int fused_ffn_launch(const void* x, const void* a, const void* w_in,
                                const void* w_gate, const void* w_out,
                                const void* ln2, void* ws, void* arrivals,
                                void* o, void* r, int B, int D, int F, int G,
                                int C, float eps, float add_r, void* stream) {
  if (!plan_ok(D, F, G, C)) return (int)cudaErrorInvalidValue;
#define ARGS G, C, (const bf16*)x, (const bf16*)a, (const bf16*)w_in,              \
    (const bf16*)w_gate, (const bf16*)w_out, (const float*)ln2, (float*)ws,      \
    (int*)arrivals, (bf16*)o, (bf16*)r, D, F, eps, add_r, (cudaStream_t)stream
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
