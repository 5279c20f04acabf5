// B5 — flash decode: GQA attention of q against a KV cache clamped by a
// length, with the optional attention softcap and sliding window; q in,
// the normalized output out.  One C entry, two device launches.
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
// Bound on an H100: bytes.  Each valid K and V row is read once for all
// query heads of its kv group (and all slots sharing the cache), at
// 4·qpk FLOPs per 2·hd·2 bytes — far under the ~295 FLOP/byte ridge.  At
// Llama2-7B (8 slots, 32 heads of 128, live lengths up to 1024) a layer
// reads ~45 MB, ~0.013 ms at 3.35 TB/s.  The Pallas grid walks the cache
// in order on one core; one block per (slot, kv head) here would leave the
// longest slots' blocks streaming alone (as B1's one block per kv head
// keeps 32 of 132 SMs busy).  So the live span is split across blocks:
//   1. flash_chunk_kernel: one block per (64-row chunk, kv head, group),
//      hd threads.  A chunk with no valid row returns before reading
//      anything (free slots and the dead tail of every slot cost one
//      length read).  The chunk's K and V rows go to shared memory with
//      16-byte loads, once for all nq = NB·qpk query rows; scores, the
//      chunk's softmax statistics and the unnormalized accumulator (one
//      column a thread) go to an f32 workspace.
//   2. flash_merge_kernel: one block per (query row, kv head, group)
//      merges the live chunks IN ORDER (no float atomics: results repeat
//      run to run), normalizes and writes o in q's dtype.
// Later work: TMA staging and wgmma for qpk > 1, and merging the chunks
// through DSMEM within a thread-block cluster instead of the workspace.
#include "common.cuh"

namespace {

constexpr int CH = 64;      // cache rows per chunk: one block each
constexpr int MAXQ = 32;    // query rows per (group, kv head)

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

// Valid rows [lo, hi) of group g: below its length (clamped to [0, S])
// and, with a window, above length - window.
struct Span { int lo, hi; };
DEVI Span live_span(const int* lens, int g, int S, int window) {
  int L = lens[g];
  L = L < 0 ? 0 : (L < S ? L : S);
  int lo = window > 0 ? L - window + 1 : 0;
  return {lo < 0 ? 0 : lo, L};
}

// Padded shared-memory row: 16 extra bytes keep 16-byte reads of
// consecutive rows on distinct banks.
template <typename T, int HD>
__host__ __device__ constexpr int row_stride() {
  return HD + 16 / (int)sizeof(T);
}

template <typename T, int HD>
size_t chunk_smem(int nq) {
  return 2 * (size_t)CH * row_stride<T, HD>() * sizeof(T)   // K, V rows
       + (size_t)nq * HD * 4                                // q rows, f32
       + (size_t)nq * CH * 4                                // scores / p
       + (size_t)2 * nq * 4;                                // m, l
}

// Query row r of group g under kv head h: slot g·NB + r / qpk, query head
// h·qpk + r % qpk of q [B, kv·qpk, HD].
DEVI size_t q_off(int g, int r, int h, int NB, int kv, int qpk, int HD) {
  const int b = g * NB + r / qpk, hq = h * qpk + r % qpk;
  return ((size_t)b * kv * qpk + hq) * HD;
}

template <typename T, int HD>
__global__ void __launch_bounds__(HD)
flash_chunk_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ lens,
                   float* __restrict__ ws, int G, int NB, int S, int kv,
                   int qpk, float scale, float cap, int window) {
  constexpr int NT = HD, NW = NT / 32, RS = row_stride<T, HD>();
  constexpr int VR = HD * (int)sizeof(T) / 16;     // 16-byte vectors a row
  const int c = blockIdx.x, h = blockIdx.y, g = blockIdx.z;
  const Span sp = live_span(lens, g, S, window);
  const int s0 = c * CH;
  const int a = max(s0, sp.lo), e = min(s0 + CH, sp.hi);
  if (a >= e) return;        // no valid row: nothing read, nothing written
  const int nq = NB * qpk, nch = gridDim.x, pa = a - s0, pe = e - s0;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + CH * RS;
  float* qs = reinterpret_cast<float*>(vs + CH * RS);     // [nq][HD]
  float* ps = qs + nq * HD;                               // [nq][CH]
  float* st = ps + nq * CH;                               // m [nq], l [nq]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < nq * HD; i += NT)
    qs[i] = to_f(q[q_off(g, i / HD, h, NB, kv, qpk, HD) + i % HD]);
  for (int i = tid; i < (pe - pa) * VR; i += NT) {
    const int p = pa + i / VR, j = i % VR;
    const size_t row = (((size_t)(s0 + p) * G + g) * kv + h) * HD;
    reinterpret_cast<uint4*>(ks + p * RS)[j] =
        __ldg(reinterpret_cast<const uint4*>(k + row) + j);
    reinterpret_cast<uint4*>(vs + p * RS)[j] =
        __ldg(reinterpret_cast<const uint4*>(v + row) + j);
  }
  __syncthreads();

  // scores: one (query row, cache row) pair a thread at a time; masked
  // rows score -1e30, as the Pallas kernel's do
  for (int i = tid; i < nq * CH; i += NT) {
    const int r = i / CH, p = i % CH;
    float s = -1e30f;
    if (p >= pa && p < pe) {
      const T* kr = ks + p * RS;
      const float* qr = qs + r * HD;
      float d = 0.f;
#pragma unroll 4
      for (int j = 0; j < HD; j += 8) {
        float kv8[8];
        smem8(kr + j, kv8);
        const float4 qa = *reinterpret_cast<const float4*>(qr + j);
        const float4 qb = *reinterpret_cast<const float4*>(qr + j + 4);
        d += qa.x * kv8[0] + qa.y * kv8[1] + qa.z * kv8[2] + qa.w * kv8[3]
           + qb.x * kv8[4] + qb.y * kv8[5] + qb.z * kv8[6] + qb.w * kv8[7];
      }
      s = d * scale;
      if (cap > 0.f) s = tanhf(s / cap) * cap;
    }
    ps[i] = s;
  }
  __syncthreads();

  // the chunk's softmax statistics, one warp per query row
  for (int r = warp; r < nq; r += NW) {
    float* pr = ps + r * CH;
    float m = -1e30f;
    for (int p = lane; p < CH; p += 32) m = fmaxf(m, pr[p]);
    m = warp_max(m);
    float l = 0.f;
    for (int p = lane; p < CH; p += 32) {
      const float x = (p >= pa && p < pe) ? expf(pr[p] - m) : 0.f;
      pr[p] = x;
      l += x;
    }
    l = warp_sum(l);
    if (lane == 0) { st[r] = m; st[nq + r] = l; }
  }
  __syncthreads();

  // p·v with p in f32, one column a thread; rows in order
  const size_t R = (size_t)G * nch * kv * nq;
  const size_t base = (((size_t)g * nch + c) * kv + h) * nq;
  float* pacc = ws + 2 * R;
  for (int r = 0; r < nq; ++r) {
    const float* pr = ps + r * CH;
    float acc = 0.f;
    for (int p = pa; p < pe; ++p) acc += pr[p] * to_f(vs[p * RS + tid]);
    pacc[(base + r) * HD + tid] = acc;
  }
  if (tid < nq) {
    ws[base + tid] = st[tid];
    ws[R + base + tid] = st[nq + tid];
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(HD)
flash_merge_kernel(const int* __restrict__ lens, const float* __restrict__ ws,
                   T* __restrict__ o, int G, int NB, int S, int kv, int qpk,
                   int nch, int window) {
  const int r = blockIdx.x, h = blockIdx.y, g = blockIdx.z, d = threadIdx.x;
  const int nq = NB * qpk;
  const Span sp = live_span(lens, g, S, window);
  const size_t R = (size_t)G * nch * kv * nq;
  float m = -1e30f, l = 0.f, acc = 0.f;
  if (sp.lo < sp.hi) {
    // exactly the chunks the first launch wrote, in order
    for (int c = sp.lo / CH; c <= (sp.hi - 1) / CH; ++c) {
      const size_t row = (((size_t)g * nch + c) * kv + h) * nq + r;
      const float mc = ws[row], m_new = fmaxf(m, mc);
      const float corr = expf(m - m_new), cc = expf(mc - m_new);
      l = l * corr + ws[R + row] * cc;
      acc = acc * corr + ws[2 * R + row * HD + d] * cc;
      m = m_new;
    }
  }
  o[q_off(g, r, h, NB, kv, qpk, HD) + d] = from_f<T>(acc / fmaxf(l, 1e-30f));
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* lens,
           void* ws, void* o, int G, int NB, int S, int kv, int qpk,
           float scale, float cap, int window, cudaStream_t st) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_chunk_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)chunk_smem<T, HD>(MAXQ));
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const int nq = NB * qpk, nch = (S + CH - 1) / CH;
  flash_chunk_kernel<T, HD><<<dim3(nch, kv, G), HD, chunk_smem<T, HD>(nq),
                              st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)lens, (float*)ws, G,
      NB, S, kv, qpk, scale, cap, window);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_merge_kernel<T, HD><<<dim3(nq, kv, G), HD, 0, st>>>(
      (const int*)lens, (const float*)ws, (T*)o, G, NB, S, kv, qpk, nch,
      window);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const void* lens, void* ws,
                                   void* o, int G, int NB, int S, int kv,
                                   int qpk, int hd, int is_f32, float scale,
                                   float cap, int window, void* stream) {
  if (G < 1 || NB < 1 || S < 1 || kv < 1 || qpk < 1 || NB * qpk > MAXQ ||
      G > 65535 || kv > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define ARGS q, k, v, lens, ws, o, G, NB, S, kv, qpk, scale, cap, window, st
  switch (hd * 2 + (is_f32 ? 1 : 0)) {
    case 64 * 2: return launch<bf16, 64>(ARGS);
    case 128 * 2: return launch<bf16, 128>(ARGS);
    case 256 * 2: return launch<bf16, 256>(ARGS);
    case 64 * 2 + 1: return launch<float, 64>(ARGS);
    case 128 * 2 + 1: return launch<float, 128>(ARGS);
    case 256 * 2 + 1: return launch<float, 256>(ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ARGS
}
