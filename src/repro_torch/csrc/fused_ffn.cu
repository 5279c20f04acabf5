// B2 — fused block tail: r = x + a, h = RMSNorm(r, ln2), gated SiLU FFN
// over d_ff tiles, second residual add.  One C entry, two launches.
//
// Replaces repro/kernels/fused_ffn/fused_ffn.py:fused_ffn_block (the
// Pallas kernel at its pallas_call, line 153) without post_ln1, gated
// SiLU.
//
// Bound on an H100: bytes — w_in, w_gate and w_out (270.5 MB at
// Llama2-7B) are read once per step for all B slots, at 2·B FLOPs per
// weight element.  Design:
//   * ffn_tile_kernel: one block per TF = 128 columns of d_ff (86 blocks
//     at d_ff = 11008, about one wave on 132 SMs, so every weight tile is
//     in flight at once).  Each block recomputes r and h in shared memory
//     (the [B, D] activations are tiny next to the weights), streams its
//     up/gate columns once with B accumulators per column, forms
//     hm = bf16(silu(bf16(g)) * bf16(u)) — the reference's rounding
//     points — and multiplies by its 128 full-width rows of w_out, writing
//     an f32 [B, D] partial to a workspace.
//   * ffn_reduce_kernel: sums the partials in tile order 0..n-1 (a fixed
//     order, so the result is the same on every run; no float atomics),
//     adds add_r * r and rounds once, as the TPU kernel's epilogue.
#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int NW = NT / 32;
constexpr int TF = 128;        // d_ff columns per block (4 per lane)

template <int B>
__host__ __device__ constexpr size_t smem_hs() { return 0; }
template <int B>
__host__ __device__ size_t smem_red(int D) { return (size_t)B * D * 2; }
template <int B>
__host__ __device__ size_t smem_hm(int D) { return smem_red<B>(D) + (size_t)2 * NW * B * TF * 4; }
template <int B>
__host__ __device__ size_t smem_small(int D) { return smem_hm<B>(D) + (size_t)B * TF * 4; }
template <int B>
__host__ __device__ size_t smem_total(int D) { return smem_small<B>(D) + (size_t)33 * B * 4; }

template <int B>
__global__ void __launch_bounds__(NT)
ffn_tile_kernel(const bf16* __restrict__ x, const bf16* __restrict__ a,
                const bf16* __restrict__ w_in, const bf16* __restrict__ w_gate,
                const bf16* __restrict__ w_out, const float* __restrict__ ln2,
                float* __restrict__ ws, int D, int F, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* hs = reinterpret_cast<bf16*>(smem + smem_hs<B>());
  float* redU = reinterpret_cast<float*>(smem + smem_red<B>(D));
  float* redG = redU + NW * B * TF;
  float* hm = reinterpret_cast<float*>(smem + smem_hm<B>(D));
  float* red2 = reinterpret_cast<float*>(smem + smem_small<B>(D));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x, f0 = tile * TF;

  // r = bf16(x + a); h = bf16(rms(r, ln2))
  rms_rows_to_smem<B>(x, a, ln2, D, eps, hs, red2);

  // up/gate columns f0 + 4·lane .. +3; warps split D
  const int f = f0 + lane * 4;
  float accU[B][4], accG[B][4];
#pragma unroll
  for (int b = 0; b < B; ++b)
#pragma unroll
    for (int j = 0; j < 4; ++j) { accU[b][j] = 0.f; accG[b][j] = 0.f; }
  if (f < F) {
#pragma unroll 4
    for (int d = warp; d < D; d += NW) {
      float wi[4], wg[4];
      load_bf16x4(w_in + (size_t)d * F + f, wi);
      load_bf16x4(w_gate + (size_t)d * F + f, wg);
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const float h = bf2f(hs[b * D + d]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          accU[b][j] += h * wi[j];
          accG[b][j] += h * wg[j];
        }
      }
    }
  }
#pragma unroll
  for (int b = 0; b < B; ++b) {
    *reinterpret_cast<float4*>(redU + ((size_t)warp * B + b) * TF + lane * 4) =
        make_float4(accU[b][0], accU[b][1], accU[b][2], accU[b][3]);
    *reinterpret_cast<float4*>(redG + ((size_t)warp * B + b) * TF + lane * 4) =
        make_float4(accG[b][0], accG[b][1], accG[b][2], accG[b][3]);
  }
  __syncthreads();
  // hm = bf16(silu(bf16(g)) * bf16(u)), zero past d_ff
  for (int idx = tid; idx < B * TF; idx += NT) {
    const int b = idx / TF, c = idx % TF;
    float u = 0.f, g = 0.f;
    for (int w = 0; w < NW; ++w) {
      u += redU[((size_t)w * B + b) * TF + c];
      g += redG[((size_t)w * B + b) * TF + c];
    }
    u = round_bf(u);
    g = round_bf(g);
    const float act = g * (1.0f / (1.0f + expf(-g)));
    hm[b * TF + c] = (f0 + c < F) ? round_bf(act * u) : 0.f;
  }
  __syncthreads();

  // partial[b, :] = hm[b, tile] · w_out[tile rows, :]
  const int nf = F - f0 < TF ? F - f0 : TF;
  for (int n0 = tid * 4; n0 < D; n0 += NT * 4) {
    float out[B][4];
#pragma unroll
    for (int b = 0; b < B; ++b)
#pragma unroll
      for (int j = 0; j < 4; ++j) out[b][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < nf; ++c) {
      float w[4];
      load_bf16x4(w_out + (size_t)(f0 + c) * D + n0, w);
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const float hv = hm[b * TF + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) out[b][j] += hv * w[j];
      }
    }
#pragma unroll
    for (int b = 0; b < B; ++b)
      *reinterpret_cast<float4*>(ws + ((size_t)tile * B + b) * D + n0) =
          make_float4(out[b][0], out[b][1], out[b][2], out[b][3]);
  }
}

// o = bf16(sum_t partial_t + add_r * r), r = bf16(x + a); tiles in order.
__global__ void ffn_reduce_kernel(const bf16* __restrict__ x,
                                  const bf16* __restrict__ a,
                                  const float* __restrict__ ws, int n_tiles,
                                  int BD, float add_r, bf16* __restrict__ o,
                                  bf16* __restrict__ r_out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= BD) return;
  float acc = 0.f;
  for (int t = 0; t < n_tiles; ++t) acc += ws[(size_t)t * BD + idx];
  const float r = round_bf(bf2f(x[idx]) + bf2f(a[idx]));
  o[idx] = f2bf(acc + r * add_r);
  r_out[idx] = f2bf(r);
}

template <int B>
int launch(const bf16* x, const bf16* a, const bf16* w_in, const bf16* w_gate,
           const bf16* w_out, const float* ln2, float* ws, bf16* o, bf16* r,
           int D, int F, float eps, float add_r, cudaStream_t stream) {
  const size_t smem = smem_total<B>(D);
  cudaError_t err = cudaFuncSetAttribute(
      ffn_tile_kernel<B>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (F + TF - 1) / TF;
  ffn_tile_kernel<B><<<n_tiles, NT, smem, stream>>>(x, a, w_in, w_gate, w_out,
                                                    ln2, ws, D, F, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int BD = B * D;
  ffn_reduce_kernel<<<(BD + 255) / 256, 256, 0, stream>>>(x, a, ws, n_tiles, BD,
                                                          add_r, o, r);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_ffn_tiles(int F) { return (F + TF - 1) / TF; }

extern "C" int fused_ffn_launch(const void* x, const void* a, const void* w_in,
                                const void* w_gate, const void* w_out,
                                const void* ln2, void* ws, void* o, void* r,
                                int B, int D, int F, float eps, float add_r,
                                void* stream) {
  if (D % 8 != 0 || F % 4 != 0) return (int)cudaErrorInvalidValue;
#define ARGS (const bf16*)x, (const bf16*)a, (const bf16*)w_in, (const bf16*)w_gate, \
    (const bf16*)w_out, (const float*)ln2, (float*)ws, (bf16*)o, (bf16*)r, D, F,     \
    eps, add_r, (cudaStream_t)stream
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
