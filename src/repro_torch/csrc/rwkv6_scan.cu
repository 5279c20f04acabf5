// B7 — RWKV-6 WKV scan: for every (slot, head), over t = 0 … S−1,
//
//     o_t[j] = Σ_i r_t[i] · (S[i][j] + u[i] · k_t[i] · v_t[j])
//     S[i][j] ← w_t[i] · S[i][j] + k_t[i] · v_t[j]
//
// with the f32 state S [hd, hd] starting from s0 and ending in s_fin.
//
// Replaces repro/kernels/rwkv6_scan/rwkv6_scan.py:rwkv6_scan_kernel (the
// Pallas kernel at its pallas_call, line 71), which keeps the
// [B, hb, hd, hd] state in VMEM while its grid walks the time blocks in
// order.  Here the state stays in registers for the whole scan and a loop
// inside the block takes the place of the sequential grid axis; any S ≥ 1
// (the Pallas wrapper's S % block_t is an artifact of its tiling).
//
// Bound on an H100: by its bytes (r, k, v, w and o read or written once,
// s0 and s_fin once) at 3.35 TB/s, with its 6·B·S·H·hd² f32 FLOPs on the
// CUDA cores (no tensor-core product) just below that.  At prefill the
// chain of S dependent steps, not bytes, sets its time: each step of a
// (slot, head) needs the state the step before wrote.  Design:
//   * one CTA per (slot, head, 32 value columns): 640 CTAs at B = 8,
//     H = 40, hd = 64, 4 warps each;
//   * lane j owns value column j of the CTA's 32; warp w owns state rows
//     [w·hd/4, (w+1)·hd/4), so each thread holds hd/4 state entries in
//     registers;
//   * per chunk of TC steps: r, k, w rows [TC, hd], the CTA's v columns
//     and (once) u are staged in shared memory with 16-byte loads (a
//     (b, t, h) row is 256 contiguous bytes); each step every thread adds
//     its rows' share of o_j into a shared partial [TC][4][32], then
//     updates its state entries; after the chunk one barrier, and the
//     four warp partials are summed in a fixed order and written;
//   * s_fin may alias s0: a CTA reads exactly the state entries it later
//     writes, and no other CTA touches them, so the engine updates the
//     state in place.  No atomics: outputs repeat from run to run.
#include "common.cuh"

namespace {

constexpr int NWARP = 4;
constexpr int NT = 32 * NWARP;
constexpr int COLS = 32;       // value columns per CTA, one per lane
constexpr int TC = 16;         // time steps staged per chunk

template <int HD>
__global__ void __launch_bounds__(NT)
wkv_scan_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* s0,
                float* __restrict__ o, float* s_fin, int S, int H) {
  constexpr int RW = HD / NWARP;       // state rows per warp
  constexpr int NCG = HD / COLS;       // column groups per head
  constexpr int Q = HD / 4;            // float4 per (b, t, h) row
  static_assert(HD % (4 * NWARP) == 0 && HD % COLS == 0, "head dim");
  __shared__ __align__(16) float sr[TC][HD];
  __shared__ __align__(16) float sk[TC][HD];
  __shared__ __align__(16) float sw[TC][HD];
  __shared__ __align__(16) float sv[TC][COLS];
  __shared__ float part[TC][NWARP][COLS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cg = blockIdx.x % NCG;
  const int bh = blockIdx.x / NCG;
  const int h = bh % H, b = bh / H;
  const int col = cg * COLS + lane;
  const int row0 = warp * RW;

  // this thread's state entries S[row0 + i][col] and the rows' u
  const size_t sbase = (size_t)bh * HD * HD;
  float st[RW], uu[RW];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    st[i] = s0[sbase + (size_t)(row0 + i) * HD + col];
    uu[i] = u[(size_t)h * HD + row0 + i];
  }

  for (int t0 = 0; t0 < S; t0 += TC) {
    const int tc = min(TC, S - t0);
    // element (b, t, h, d) lies at ((b·S + t)·H + h)·HD + d
    for (int idx = tid; idx < tc * Q; idx += NT) {
      const int tt = idx / Q, q = idx % Q;
      const size_t off = ((size_t)(b * S + t0 + tt) * H + h) * HD + q * 4;
      *reinterpret_cast<float4*>(&sr[tt][q * 4]) =
          __ldg(reinterpret_cast<const float4*>(r + off));
      *reinterpret_cast<float4*>(&sk[tt][q * 4]) =
          __ldg(reinterpret_cast<const float4*>(k + off));
      *reinterpret_cast<float4*>(&sw[tt][q * 4]) =
          __ldg(reinterpret_cast<const float4*>(w + off));
    }
    for (int idx = tid; idx < tc * (COLS / 4); idx += NT) {
      const int tt = idx / (COLS / 4), q = idx % (COLS / 4);
      const size_t off =
          ((size_t)(b * S + t0 + tt) * H + h) * HD + cg * COLS + q * 4;
      *reinterpret_cast<float4*>(&sv[tt][q * 4]) =
          __ldg(reinterpret_cast<const float4*>(v + off));
    }
    __syncthreads();

    for (int tt = 0; tt < tc; ++tt) {
      const float vj = sv[tt][lane];
      const float4* r4 = reinterpret_cast<const float4*>(&sr[tt][row0]);
      const float4* k4 = reinterpret_cast<const float4*>(&sk[tt][row0]);
      const float4* w4 = reinterpret_cast<const float4*>(&sw[tt][row0]);
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < RW / 4; ++q) {
        const float4 rq = r4[q], kq = k4[q], wq = w4[q];
        const float rr[4] = {rq.x, rq.y, rq.z, rq.w};
        const float kk[4] = {kq.x, kq.y, kq.z, kq.w};
        const float ww[4] = {wq.x, wq.y, wq.z, wq.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = q * 4 + e;
          const float kv = kk[e] * vj;
          acc = fmaf(rr[e], fmaf(uu[i], kv, st[i]), acc);
          st[i] = fmaf(ww[e], st[i], kv);
        }
      }
      part[tt][warp][lane] = acc;
    }
    __syncthreads();

    // the four warps' partials, summed in a fixed order
    for (int idx = tid; idx < tc * COLS; idx += NT) {
      const int tt = idx / COLS, j = idx % COLS;
      const float sum =
          ((part[tt][0][j] + part[tt][1][j]) + part[tt][2][j]) + part[tt][3][j];
      o[((size_t)(b * S + t0 + tt) * H + h) * HD + cg * COLS + j] = sum;
    }
    // the next chunk stages r/k/w/v (not part) first, and writes part only
    // after the barrier that follows its staging
  }

#pragma unroll
  for (int i = 0; i < RW; ++i)
    s_fin[sbase + (size_t)(row0 + i) * HD + col] = st[i];
}

}  // namespace

// r, k, v, w, o: [B, S, H, hd] f32; u: [H, hd] f32; s0, s_fin:
// [B, H, hd, hd] f32 (s_fin may be s0).  Every pointer 16-byte aligned.
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const void* w, const void* u, const void* s0,
                                 void* o, void* s_fin, int B, int S, int H,
                                 int hd, void* stream) {
  if (B < 1 || S < 1 || H < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 64: {
      const int grid = B * H * (64 / COLS);
      wkv_scan_kernel<64><<<grid, NT, 0, st>>>(
          (const float*)r, (const float*)k, (const float*)v, (const float*)w,
          (const float*)u, (const float*)s0, (float*)o, (float*)s_fin, S, H);
      return (int)cudaGetLastError();
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}
