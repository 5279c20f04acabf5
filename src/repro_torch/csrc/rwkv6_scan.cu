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
// s0 and s_fin once) at 3.35 TB/s, with its f32 FLOPs on the CUDA cores
// (no tensor-core product) just below that.  At prefill, not bytes but
// the work each of the S dependent steps issues — its FMAs and its
// shared-memory reads — sets its time.  Design (S > 1, wkv_scan_kernel):
//   * one CTA per (slot, head, 32 value columns): 640 CTAs at B = 8,
//     H = 40, hd = 64, each two scan warps and one io warp, all resident
//     at once (5 an SM);
//   * the arithmetic is the one-column-a-thread scan's, to the bit: the
//     state rows fall into four groups of hd/4, a group's share of o_j is
//     one FMA chain over its rows in order, from 0,
//         kv = k_i·v_j;  acc = fma(r_i, fma(u_i, kv, S_ij), acc);
//         S_ij = fma(w_i, S_ij, kv),
//     and o_j is the four groups' sums added in group order.  (Splitting
//     the output term as r·S + v·(Σ r⊙u⊙k) saves an FMA an entry but
//     rounds o otherwise, and RWKV-6's teacher-forced tokens then left
//     the plain version's: PERF.md §6.)  Scan lane (p, q) of warp w
//     holds columns 2p, 2p + 1 of row group 2w + q, 32 state entries in
//     registers, so every r, k, w value it reads from shared memory
//     serves two columns;
//   * r, k, w rows [TC, hd] and the CTA's v columns stream through a ring
//     of NS = 4 chunks of TC = 8 steps, two chunks in flight while one is
//     scanned.  A chunk is four TMA boxes (2-D tensor maps over the
//     [B·S, H·hd] inputs) completing on the slot's mbarrier.  One barrier
//     a chunk: after it the io warp issues chunk c + 2's boxes and writes
//     chunk c − 1's outputs (the four groups' partials added in group
//     order) while the scan warps take chunk c, whose partials go to the
//     other half of a double buffer;
//   * at S = 1 (decode, one step and launch-bound) wkv_step_kernel, the
//     same CTAs, lanes and arithmetic with every load issued at entry and
//     no ring;
//   * s_fin may alias s0: a CTA reads exactly the state entries it later
//     writes, and no other CTA touches them, so the engine updates the
//     state in place.  No atomics: outputs repeat from run to run.
#include <cuda.h>          // CUtensorMap (encoded through the runtime's
                           // driver entry point: nothing links libcuda)
#include "cluster.cuh"     // TMA copies and mbarriers

namespace {

constexpr int NWARP = 2;       // scan warps
constexpr int NT = 32 * NWARP;   // scan threads
constexpr int NTT = NT + 32;     // and one warp that loads and writes o
constexpr int NG = 4;          // row groups (one FMA chain each)
constexpr int COLS = 32;       // value columns per CTA
constexpr int TC = 8;          // time steps a chunk
constexpr int NS = 4;          // ring slots (chunks)
constexpr int P = 2;           // chunks in flight ahead of the scanned one

DEVI void unpack4(float4 x, float* d) {
  d[0] = x.x; d[1] = x.y; d[2] = x.z; d[3] = x.w;
}

// One step of a row group for a lane's two columns: the group's partial
// sums of o (one chain a column, over the rows in order, from 0) and the
// updated state.  rr, kk, ww, uu: the group's rows of r, k, w and u.
template <int RW>
DEVI float2 group_step(const float* rr, const float* kk, const float* ww,
                       const float* uu, float2 vj, float2* st) {
  float2 a = make_float2(0.f, 0.f);
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const float kv0 = __fmul_rn(kk[i], vj.x), kv1 = __fmul_rn(kk[i], vj.y);
    a.x = fmaf(rr[i], fmaf(uu[i], kv0, st[i].x), a.x);
    a.y = fmaf(rr[i], fmaf(uu[i], kv1, st[i].y), a.y);
    st[i].x = fmaf(ww[i], st[i].x, kv0);
    st[i].y = fmaf(ww[i], st[i].y, kv1);
  }
  return a;
}

// r, k, w and v as [B·S, H·HD] row-major f32 matrices, each a tensor map
// whose box is [min(TC, S) rows, HD columns] (v: COLS columns)
template <int HD>
__global__ void __launch_bounds__(NTT, 5)
wkv_scan_kernel(const __grid_constant__ CUtensorMap tr,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tw,
                const __grid_constant__ CUtensorMap tv,
                const float* __restrict__ u, const float* s0,
                float* __restrict__ o, float* s_fin, int S, int H) {
  constexpr int RW = HD / NG;          // state rows per group (and lane)
  constexpr int NCG = HD / COLS;       // column groups per head
  static_assert(RW % 4 == 0 && HD % COLS == 0 && NG == 2 * NWARP, "head dim");
  __shared__ __align__(128) float sr[NS][TC][HD];
  __shared__ __align__(128) float sk[NS][TC][HD];
  __shared__ __align__(128) float sw[NS][TC][HD];
  __shared__ __align__(128) float sv[NS][TC][COLS];
  __shared__ __align__(8) float part[2][TC][NG][COLS];
  __shared__ __align__(8) uint64_t bar[NS];      // a slot's loads landed

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool io = warp == NWARP;                 // the load-and-output warp
  const int cg = blockIdx.x % NCG;
  const int bh = blockIdx.x / NCG;
  const int h = bh % H, b = bh / H;
  // scan lane (p, q): columns 2p, 2p + 1 of the CTA's COLS, row group
  // g = 2·warp + q, rows [g·RW, (g + 1)·RW)
  const int g = 2 * warp + (lane >> 4), pc = 2 * (lane & 15);
  const int col = cg * COLS + pc, row0 = g * RW;
  const int nch = (S + TC - 1) / TC;
  // element (b, t, h, d) lies at ((b·S + t)·H + h)·HD + d
  auto at = [&](int t) { return ((size_t)(b * S + t) * H + h) * HD; };

  // a chunk's loads, by the io warp's lane 0: four TMA boxes of min(TC, S)
  // steps — the r, k and w rows and the CTA's v columns — completing on
  // the slot's mbarrier (a last chunk's box may run into the next slot's
  // rows, or past the end, zero-filled; they are not read)
  const int tb = min(TC, S);
  auto load = [&](int c) {
    if (!io || lane != 0 || c >= nch) return;
    const int sl = c % NS, row = b * S + c * TC;
    mbar_expect_tx(&bar[sl], tb * (3 * HD + COLS) * 4);
    tma_2d(sr[sl], &tr, h * HD, row, &bar[sl]);
    tma_2d(sk[sl], &tk, h * HD, row, &bar[sl]);
    tma_2d(sw[sl], &tw, h * HD, row, &bar[sl]);
    tma_2d(sv[sl], &tv, h * HD + cg * COLS, row, &bar[sl]);
  };
  // o of chunk c, by the io warp: the four groups' partials in group
  // order; lane j column j
  auto write_out = [&](int c) {
    if (!io) return;
    const int t0 = c * TC, tc = min(TC, S - t0), pb = c & 1;
    for (int tt = 0; tt < tc; ++tt)
      o[at(t0 + tt) + cg * COLS + lane] =
          ((part[pb][tt][0][lane] + part[pb][tt][1][lane]) +
           part[pb][tt][2][lane]) + part[pb][tt][3][lane];
  };
  if (tid < NS) mbar_init(&bar[tid], 1);
  __syncthreads();
#pragma unroll
  for (int c = 0; c < P; ++c) load(c);

  // a scan thread's state entries S[row0 + i][col + j] and its rows of u
  const size_t sbase = (size_t)bh * HD * HD;
  float2 st[RW];
  float uu[RW];
  if (!io) {
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      st[i] = *reinterpret_cast<const float2*>(s0 + sbase + (size_t)(row0 + i) * HD + col);
      uu[i] = __ldg(u + (size_t)h * HD + row0 + i);
    }
  }

  for (int c = 0; c < nch; ++c) {
    const int tc = min(TC, S - c * TC), sl = c % NS, pb = c & 1;
    // chunk c has landed (the parity of its slot's use); every thread is
    // done with chunk c − 2 (its slot and its half of part are free) and
    // with chunk c − 1's scan
    mbar_wait(&bar[sl], (c / NS) & 1);
    __syncthreads();
    if (io) {
      load(c + P);
      if (c > 0) write_out(c - 1);
      continue;
    }
    auto step = [&](int tt) {
      float rr[RW], kk[RW], ww[RW];
#pragma unroll
      for (int i = 0; i < RW; i += 4) {
        unpack4(*reinterpret_cast<const float4*>(&sr[sl][tt][row0 + i]), rr + i);
        unpack4(*reinterpret_cast<const float4*>(&sk[sl][tt][row0 + i]), kk + i);
        unpack4(*reinterpret_cast<const float4*>(&sw[sl][tt][row0 + i]), ww + i);
      }
      const float2 vj = *reinterpret_cast<const float2*>(&sv[sl][tt][pc]);
      *reinterpret_cast<float2*>(&part[pb][tt][g][pc]) =
          group_step<RW>(rr, kk, ww, uu, vj, st);
    };
    if (tc == TC) {
#pragma unroll
      for (int tt = 0; tt < TC; ++tt) step(tt);
    } else {
      for (int tt = 0; tt < tc; ++tt) step(tt);
    }
  }
  __syncthreads();
  write_out(nch - 1);

  if (!io) {
#pragma unroll
    for (int i = 0; i < RW; ++i)
      *reinterpret_cast<float2*>(s_fin + sbase + (size_t)(row0 + i) * HD + col) = st[i];
  }
}

// One step (S = 1), as wkv_scan_kernel's scan warps take a step: the same
// CTAs, lanes and arithmetic; r, k, v, w, u and the state read with
// 16-byte (state: 8-byte) loads, all issued at entry.
template <int HD>
__global__ void __launch_bounds__(NT)
wkv_step_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* s0,
                float* __restrict__ o, float* s_fin, int H) {
  constexpr int RW = HD / NG;
  constexpr int NCG = HD / COLS;
  __shared__ __align__(8) float part[NG][COLS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cg = blockIdx.x % NCG, bh = blockIdx.x / NCG, h = bh % H;
  const int g = 2 * warp + (lane >> 4), pc = 2 * (lane & 15);
  const int col = cg * COLS + pc, row0 = g * RW;
  const size_t in = (size_t)bh * HD, sbase = in * HD;   // [B, 1, H, HD]
  float2 st[RW];
  float rr[RW], kk[RW], ww[RW], uu[RW];
#pragma unroll
  for (int i = 0; i < RW; ++i)
    st[i] = *reinterpret_cast<const float2*>(s0 + sbase + (size_t)(row0 + i) * HD + col);
#pragma unroll
  for (int i = 0; i < RW; i += 4) {
    unpack4(__ldg(reinterpret_cast<const float4*>(r + in + row0 + i)), rr + i);
    unpack4(__ldg(reinterpret_cast<const float4*>(k + in + row0 + i)), kk + i);
    unpack4(__ldg(reinterpret_cast<const float4*>(w + in + row0 + i)), ww + i);
    unpack4(__ldg(reinterpret_cast<const float4*>(u + (size_t)h * HD + row0 + i)),
            uu + i);
  }
  const float2 vj = __ldg(reinterpret_cast<const float2*>(v + in + col));
  *reinterpret_cast<float2*>(&part[g][pc]) =
      group_step<RW>(rr, kk, ww, uu, vj, st);
  __syncthreads();
  if (warp == 0)
    o[in + cg * COLS + lane] =
        ((part[0][lane] + part[1][lane]) + part[2][lane]) + part[3][lane];
#pragma unroll
  for (int i = 0; i < RW; ++i)
    *reinterpret_cast<float2*>(s_fin + sbase + (size_t)(row0 + i) * HD + col) = st[i];
}

// cuTensorMapEncodeTiled through the runtime (no link to libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a [rows, cols] row-major f32 matrix at `base` in boxes of [box_rows,
// box_cols]
bool tensor_map(CUtensorMap* m, const void* base, uint64_t rows,
                uint64_t cols, uint32_t box_rows, uint32_t box_cols) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * 4};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base),
             dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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
      if (S == 1) {
        wkv_step_kernel<64><<<grid, NT, 0, st>>>(
            (const float*)r, (const float*)k, (const float*)v, (const float*)w,
            (const float*)u, (const float*)s0, (float*)o, (float*)s_fin, H);
        return (int)cudaGetLastError();
      }
      CUtensorMap m[4];
      const uint64_t rows = (uint64_t)B * S, cols = (uint64_t)H * 64;
      const uint32_t tb = S < TC ? (uint32_t)S : (uint32_t)TC;
      if (!tensor_map(&m[0], r, rows, cols, tb, 64) ||
          !tensor_map(&m[1], k, rows, cols, tb, 64) ||
          !tensor_map(&m[2], w, rows, cols, tb, 64) ||
          !tensor_map(&m[3], v, rows, cols, tb, COLS))
        return (int)cudaErrorNotSupported;
      wkv_scan_kernel<64><<<grid, NTT, 0, st>>>(
          m[0], m[1], m[2], m[3], (const float*)u, (const float*)s0,
          (float*)o, (float*)s_fin, S, H);
      return (int)cudaGetLastError();
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}
