// B6 — the RG-LRU scan (Griffin's diagonal linear recurrence): for every
// (slot b, channel c), over t = 0 … S−1,
//
//     h_t = exp(log_a_t) · h_{t−1} + b_t,     h_{−1} = h0
//
// writing every h_t to h_seq and the last one to h_fin, all in f32.
//
// Replaces repro/kernels/rglru_scan/rglru_scan.py:rglru_scan_kernel (the
// Pallas kernel at its pallas_call, line 61), whose grid runs channel
// blocks in parallel and time blocks in order with the [B, C] state in
// VMEM scratch.  Here a loop inside the thread takes the place of the
// sequential grid axis and the state stays in a register for the whole
// scan; any S ≥ 1 (the Pallas wrapper's S % block_t is an artifact of its
// tiling).
//
// Bound on an H100: by its bytes — log_a and b read once, h_seq written
// once (3·B·S·C·4), h0 read and h_fin written once — at 3.35 TB/s; its
// 3 operations an element are nothing beside them.  Each step depends on
// the one before, so the chain's memory latency, not the rate, is what a
// simple kernel has to hide.  Design:
//   * one thread per (slot, channel), h in a register; channels are
//     contiguous in [B, S, C], so a warp's loads and stores of one step
//     are 128 contiguous bytes;
//   * the loads of a chunk of TC steps (log_a and b) are issued into
//     registers before the dependent multiply-add chain runs over them:
//     they do not depend on each other, so the latency is paid once a
//     chunk, not once a step;
//   * 128-thread blocks: at B = 8, C = 4096 the 32768 threads make 256
//     blocks, about two for each of the 132 SMs;
//   * h_fin may alias h0: a thread reads its h0 before the loop and
//     writes its h_fin after it, and no other thread touches either, so
//     the engine updates the state in place.  No atomics: results repeat
//     from run to run.
#include "common.cuh"

namespace {

constexpr int NT = 128;   // threads per block
constexpr int TC = 16;    // time steps whose loads are issued together

__global__ void __launch_bounds__(NT)
rglru_scan_kernel(const float* __restrict__ log_a,
                  const float* __restrict__ b, const float* h0,
                  float* __restrict__ h_seq, float* h_fin, int B, int S,
                  int C) {
  const long long idx = (long long)blockIdx.x * NT + threadIdx.x;
  if (idx >= (long long)B * C) return;
  const int slot = (int)(idx / C), c = (int)(idx % C);
  // element (slot, t, c) lies at (slot·S + t)·C + c
  const size_t base = (size_t)slot * S * C + c;
  float h = h0[idx];
  for (int t0 = 0; t0 < S; t0 += TC) {
    float la[TC], bb[TC];
#pragma unroll
    for (int i = 0; i < TC; ++i) {
      if (t0 + i < S) {
        const size_t off = base + (size_t)(t0 + i) * C;
        la[i] = __ldg(log_a + off);
        bb[i] = __ldg(b + off);
      }
    }
#pragma unroll
    for (int i = 0; i < TC; ++i) {
      if (t0 + i < S) {
        h = expf(la[i]) * h + bb[i];
        h_seq[base + (size_t)(t0 + i) * C] = h;
      }
    }
  }
  h_fin[idx] = h;
}

}  // namespace

// log_a, b, h_seq: [B, S, C] f32; h0, h_fin: [B, C] f32 (h_fin may be h0).
extern "C" int rglru_scan_launch(const void* log_a, const void* b,
                                 const void* h0, void* h_seq, void* h_fin,
                                 int B, int S, int C, void* stream) {
  if (B < 1 || S < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * C;
  const int grid = (int)((n + NT - 1) / NT);
  rglru_scan_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const float*)log_a, (const float*)b, (const float*)h0, (float*)h_seq,
      (float*)h_fin, B, S, C);
  return (int)cudaGetLastError();
}
