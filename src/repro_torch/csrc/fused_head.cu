// B3 — fused LM-head / sampling tail: final RMSNorm, f32 logits one vocab
// tile at a time, per-slot top-k under (value desc, index asc).  One C
// entry, two launches; the [B, V] logits never reach device memory.
//
// Replaces repro/kernels/fused_head/fused_head.py:fused_head_block (the
// Pallas kernel at its pallas_call, line 128) with topk.select_topk, no
// softcap.
//
// Bound on an H100: bytes — the [V, D] table (262 MB at Llama2-7B) is
// read once per step for all B slots (2·B FLOPs per element).  Design:
//   * head_tile_kernel: one block per TV = 128 vocab rows (250 blocks at
//     V = 32000; the ragged last tile is masked, so V needs no divisor).
//     Each block recomputes the rounded final norm in shared memory, one
//     warp per row streams it with 16-byte loads and B accumulators, and
//     a warp per slot selects the tile's top-k (lanes keep sorted lists in
//     registers, the warp pops the global best k).
//   * head_merge_kernel: merges the [n_tiles, B, k] partials per slot in
//     the same total order — the k-wide topk_pair_merge, inside the
//     kernel's own launches.
#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int NW = NT / 32;
constexpr int TV = 128;        // vocab rows per block

template <int B>
__host__ __device__ size_t smem_lg(int D) { return (size_t)B * D * 2; }
template <int B>
__host__ __device__ size_t smem_small(int D) { return smem_lg<B>(D) + (size_t)B * TV * 4; }
template <int B>
__host__ __device__ size_t smem_total(int D) { return smem_small<B>(D) + (size_t)33 * B * 4; }

template <int B>
__global__ void __launch_bounds__(NT)
head_tile_kernel(const bf16* __restrict__ x, const bf16* __restrict__ table,
                 const float* __restrict__ ln, int D, int V, int K, float eps,
                 float* __restrict__ part_v, int* __restrict__ part_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* hs = reinterpret_cast<bf16*>(smem);
  float* lg = reinterpret_cast<float*>(smem + smem_lg<B>(D));
  float* red2 = reinterpret_cast<float*>(smem + smem_small<B>(D));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x, v0 = tile * TV;

  rms_rows_to_smem<B>(x, nullptr, ln, D, eps, hs, red2);

  // f32 logits: one warp per vocab row, 8 dims per lane per step
  for (int r = warp; r < TV; r += NW) {
    const int v = v0 + r;
    if (v >= V) {
      if (lane < B) lg[lane * TV + r] = -INFINITY;
      continue;
    }
    const bf16* row = table + (size_t)v * D;
    float acc[B];
#pragma unroll
    for (int b = 0; b < B; ++b) acc[b] = 0.f;
#pragma unroll 4
    for (int d0 = lane * 8; d0 < D; d0 += 256) {
      float t[8];
      load_bf16x8(row + d0, t);
#pragma unroll
      for (int b = 0; b < B; ++b) {
        float h[8];
        smem_bf16x8(hs + b * D + d0, h);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[b] += h[j] * t[j];
      }
    }
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const float s = warp_sum(acc[b]);
      if (lane == 0) lg[b * TV + r] = s;
    }
  }
  __syncthreads();

  // per-slot top-k of the tile
  for (int b = warp; b < B; b += NW) {
    LaneTopK t;
    t.init();
    for (int r = lane; r < TV; r += 32)
      if (v0 + r < V) t.insert(lg[b * TV + r], v0 + r);
    warp_topk_write(t, K, part_v + ((size_t)tile * B + b) * K,
                    part_i + ((size_t)tile * B + b) * K);
  }
}

template <int B>
__global__ void __launch_bounds__(NT)
head_merge_kernel(const float* __restrict__ part_v, const int* __restrict__ part_i,
                  int n_tiles, int K, float* __restrict__ out_v,
                  int* __restrict__ out_i) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int b = warp; b < B; b += NW) {
    LaneTopK t;
    t.init();
    for (int j = lane; j < n_tiles * K; j += 32) {
      const size_t at = ((size_t)(j / K) * B + b) * K + j % K;
      t.insert(part_v[at], part_i[at]);
    }
    warp_topk_write(t, K, out_v + (size_t)b * K, out_i + (size_t)b * K);
  }
}

template <int B>
int launch(const bf16* x, const bf16* table, const float* ln, float* part_v,
           int* part_i, float* out_v, int* out_i, int D, int V, int K, float eps,
           cudaStream_t stream) {
  const size_t smem = smem_total<B>(D);
  cudaError_t err = cudaFuncSetAttribute(
      head_tile_kernel<B>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (V + TV - 1) / TV;
  head_tile_kernel<B><<<n_tiles, NT, smem, stream>>>(x, table, ln, D, V, K, eps,
                                                     part_v, part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  head_merge_kernel<B><<<1, NT, 0, stream>>>(part_v, part_i, n_tiles, K, out_v,
                                             out_i);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_head_tiles(int V) { return (V + TV - 1) / TV; }

extern "C" int fused_head_launch(const void* x, const void* table, const void* ln,
                                 void* part_v, void* part_i, void* out_v,
                                 void* out_i, int B, int D, int V, int K,
                                 float eps, void* stream) {
  if (D % 8 != 0 || K < 1 || K > TOPK_MAXK) return (int)cudaErrorInvalidValue;
#define ARGS (const bf16*)x, (const bf16*)table, (const float*)ln, (float*)part_v, \
    (int*)part_i, (float*)out_v, (int*)out_i, D, V, K, eps, (cudaStream_t)stream
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
