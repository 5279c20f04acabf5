// B1 — fused RMSNorm + QKV-Projection + RoPE + ragged decode attention +
// per-head Output-Projection ("partial_o"), one launch for all B slots.
//
// Replaces repro/kernels/fused_decode/fused_decode.py:fused_decode_attention
// (the Pallas kernel at its pallas_call, line 374) in the serving mode:
// fused ln1, linear cache, no bias/window/softcap, q_per_kv = 1 (MHA).
//
// Bound on an H100: bytes.  Per layer the weights (wqkv + wo, 134 MB at
// Llama2-7B) and each slot's live KV are read once; the arithmetic is a
// few FLOPs per byte.  Design: one block per kv head.  The block
//   1. normalizes x for all B slots into shared memory (bf16, rounded as
//      the reference rounds before the projection);
//   2. streams its head's q/k/v columns of wqkv ONCE, keeping B
//      accumulators per column (the TPU path vmapped the kernel per slot
//      and so re-read the weights B times);
//   3. applies RoPE in f32 and writes the rounded k_new/v_new;
//   4. runs online softmax per slot over positions < cache_len with
//      pos in [0, cache_len) — lane-per-position scores, warp-per-slot
//      softmax, warps splitting positions for P·V — in chunks of CH;
//   5. folds in the new token (f32 k/v, gated by include_new, m from
//      -1e30) and projects the unnormalized accumulator through wo[h]:
//      o[b, h, :] = acc[b, h, :] · wo[h].
// Only 32 blocks run at Llama2-7B (one per head); splitting heads across
// a thread-block cluster with DSMEM reductions is the planned speed-up.
#include "common.cuh"

namespace {

constexpr int NT = 384;        // 12 warps
constexpr int NW = NT / 32;
constexpr int CH = 256;        // positions per attention chunk

template <int B, int HD>
struct Smem {
  // phases 1-2
  static constexpr int NC = 3 * HD;               // q | k | v columns
  static constexpr int DP = NT / (NC / 4);        // D partitions
  static constexpr size_t xs = 0;                 // bf16 [B][D]
  __host__ __device__ static size_t red(int D) { return xs + (size_t)B * D * 2; }   // f32 [DP][B][NC]
  __host__ __device__ static size_t phase12(int D) { return red(D) + (size_t)DP * B * NC * 4; }
  // phase 4 (aliases phases 1-2)
  static constexpr size_t sc = 0;                             // f32 [B][CH]
  static constexpr size_t accred = sc + (size_t)B * CH * 4;   // f32 [NW][B][HD]
  static constexpr size_t phase4 = accred + (size_t)NW * B * HD * 4;
  // persistent
  __host__ __device__ static size_t q(int D) { return (phase12(D) > phase4 ? phase12(D) : phase4); }
  __host__ __device__ static size_t kn(int D) { return q(D) + (size_t)B * HD * 4; }
  __host__ __device__ static size_t vn(int D) { return kn(D) + (size_t)B * HD * 4; }
  __host__ __device__ static size_t acc(int D) { return vn(D) + (size_t)B * HD * 4; }
  __host__ __device__ static size_t small(int D) { return acc(D) + (size_t)B * HD * 4; }
  // small: m[B], l[B], corr[B], fp[B], red2[33*B]
  __host__ __device__ static size_t total(int D) { return small(D) + (size_t)(4 * B + 33 * B) * 4; }
};

template <int B, int HD>
__global__ void __launch_bounds__(NT)
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
  using L = Smem<B, HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = blockIdx.x;                 // kv head == q head (MHA)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  bf16* xs = reinterpret_cast<bf16*>(smem + L::xs);
  float* red = reinterpret_cast<float*>(smem + L::red(D));
  float* sc = reinterpret_cast<float*>(smem + L::sc);
  float* accred = reinterpret_cast<float*>(smem + L::accred);
  float* q_s = reinterpret_cast<float*>(smem + L::q(D));
  float* kn_s = reinterpret_cast<float*>(smem + L::kn(D));
  float* vn_s = reinterpret_cast<float*>(smem + L::vn(D));
  float* acc_s = reinterpret_cast<float*>(smem + L::acc(D));
  float* m_s = reinterpret_cast<float*>(smem + L::small(D));
  float* l_s = m_s + B;
  float* corr_s = l_s + B;
  float* fp_s = corr_s + B;
  float* red2 = fp_s + B;

  // ---- phase 1: RMSNorm(x, ln1) for all slots, rounded to bf16 -------
  rms_rows_to_smem<B>(x, nullptr, ln1, D, eps, xs, red2);

  // ---- phase 2: this head's q|k|v columns of wqkv, read once ----------
  constexpr int NC = L::NC, DP = L::DP, CQ = NC / 4;
  const int P = (nq + 2 * nkv) * HD;
  if (tid < CQ * DP) {
    const int quad = tid % CQ, dpart = tid / CQ;
    const int c0 = quad * 4, sec = c0 / HD, off = c0 % HD;
    const int col = (sec == 0 ? 0 : (sec == 1 ? nq : nq + nkv)) * HD + g * HD + off;
    float acc[B][4];
#pragma unroll
    for (int b = 0; b < B; ++b)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[b][j] = 0.f;
#pragma unroll 4
    for (int d = dpart; d < D; d += DP) {
      float w[4];
      load_bf16x4(wqkv + (size_t)d * P + col, w);
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const float xv = bf2f(xs[b * D + d]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[b][j] += xv * w[j];
      }
    }
#pragma unroll
    for (int b = 0; b < B; ++b)
      *reinterpret_cast<float4*>(red + ((size_t)dpart * B + b) * NC + c0) =
          make_float4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]);
  }
  __syncthreads();
  for (int idx = tid; idx < B * NC; idx += NT) {
    const int b = idx / NC, c = idx % NC;
    float v = 0.f;
    for (int dp = 0; dp < DP; ++dp) v += red[((size_t)dp * B + b) * NC + c];
    if (c < HD) q_s[b * HD + c] = v;
    else if (c < 2 * HD) kn_s[b * HD + c - HD] = v;
    else vn_s[b * HD + c - 2 * HD] = v;
  }
  __syncthreads();

  // ---- phase 3: RoPE (rotate halves) on q and k, in f32 ---------------
  constexpr int HALF = HD / 2;
  for (int idx = tid; idx < B * HALF; idx += NT) {
    const int b = idx / HALF, i = idx % HALF;
    const float c = cosv[b * HALF + i], s = sinv[b * HALF + i];
    float* qr = q_s + b * HD;
    float* kr = kn_s + b * HD;
    const float q1 = qr[i], q2 = qr[i + HALF];
    qr[i] = q1 * c - q2 * s;
    qr[i + HALF] = q2 * c + q1 * s;
    const float k1 = kr[i], k2 = kr[i + HALF];
    kr[i] = k1 * c - k2 * s;
    kr[i + HALF] = k2 * c + k1 * s;
  }
  if (tid < B) { m_s[tid] = -1e30f; l_s[tid] = 0.f; }
  __syncthreads();
  for (int idx = tid; idx < B * HD; idx += NT) {
    const int b = idx / HD, d = idx % HD;
    k_new[((size_t)b * nkv + g) * HD + d] = f2bf(kn_s[idx]);
    v_new[((size_t)b * nkv + g) * HD + d] = f2bf(vn_s[idx]);
  }

  // ---- phase 4: online softmax over each slot's live prefix -----------
  int Lb[B];
  int maxL = 0;
#pragma unroll
  for (int b = 0; b < B; ++b) {
    int cl = cache_lens[b];
    Lb[b] = cl < 0 ? 0 : (cl < S ? cl : S);
    maxL = Lb[b] > maxL ? Lb[b] : maxL;
  }
  constexpr int DPL = HD / 32;              // dims per lane in P·V
  float accw[B][DPL];
#pragma unroll
  for (int b = 0; b < B; ++b)
#pragma unroll
    for (int j = 0; j < DPL; ++j) accw[b][j] = 0.f;
  const size_t srow = (size_t)B * nkv * HD;  // cache stride per position

  for (int c0 = 0; c0 < maxL; c0 += CH) {
    // scores: one lane per (slot, position)
    for (int it = tid; it < B * CH; it += NT) {
      const int b = it / CH, sl = it % CH, s = c0 + sl;
      float score = -INFINITY;
      const int cl = cache_lens[b];
      if (s < cl && s < S) {
        const int p = pos[(size_t)s * B + b];
        if (p >= 0 && p < cl) {
          const bf16* kr = kc + s * srow + ((size_t)b * nkv + g) * HD;
          const float* qr = q_s + b * HD;
          float dot = 0.f;
#pragma unroll
          for (int d = 0; d < HD; d += 8) {
            float kv8[8];
            load_bf16x8(kr + d, kv8);
            const float4 qa = *reinterpret_cast<const float4*>(qr + d);
            const float4 qb = *reinterpret_cast<const float4*>(qr + d + 4);
            dot += qa.x * kv8[0] + qa.y * kv8[1] + qa.z * kv8[2] + qa.w * kv8[3]
                 + qb.x * kv8[4] + qb.y * kv8[5] + qb.z * kv8[6] + qb.w * kv8[7];
          }
          score = dot * scale;
        }
      }
      sc[b * CH + sl] = score;
    }
    __syncthreads();
    // softmax statistics: one warp per slot
    for (int b = warp; b < B; b += NW) {
      float cmax = -INFINITY;
      for (int sl = lane; sl < CH; sl += 32) cmax = fmaxf(cmax, sc[b * CH + sl]);
      cmax = warp_max(cmax);
      const float m_old = m_s[b];
      const float m_new = fmaxf(m_old, cmax);
      float psum = 0.f;
      for (int sl = lane; sl < CH; sl += 32) {
        const float sv = sc[b * CH + sl];
        const float p = sv == -INFINITY ? 0.f : expf(sv - m_new);
        sc[b * CH + sl] = p;
        psum += p;
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        corr_s[b] = corr;
        l_s[b] = l_s[b] * corr + psum;
        m_s[b] = m_new;
      }
    }
    __syncthreads();
    // P·V: warps split positions, each lane owns DPL head dims
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const float corr = corr_s[b];
#pragma unroll
      for (int j = 0; j < DPL; ++j) accw[b][j] *= corr;
      const int n = Lb[b] - c0 < CH ? Lb[b] - c0 : CH;
      for (int sl = warp; sl < n; sl += NW) {
        const float p = sc[b * CH + sl];
        if (p == 0.f) continue;
        const bf16* vr = vc + (size_t)(c0 + sl) * srow + ((size_t)b * nkv + g) * HD
                       + lane * DPL;
        float vv[DPL];
        if (DPL == 4) {
          load_bf16x4(vr, vv);
        } else {
#pragma unroll
          for (int j = 0; j < DPL; ++j) vv[j] = bf2f(vr[j]);
        }
#pragma unroll
        for (int j = 0; j < DPL; ++j) accw[b][j] += p * vv[j];
      }
    }
    __syncthreads();
  }
  // combine the warps' partial accumulators (fixed order)
#pragma unroll
  for (int b = 0; b < B; ++b)
#pragma unroll
    for (int j = 0; j < DPL; ++j)
      accred[((size_t)warp * B + b) * HD + lane * DPL + j] = accw[b][j];
  __syncthreads();
  for (int idx = tid; idx < B * HD; idx += NT) {
    float v = 0.f;
    for (int w = 0; w < NW; ++w) v += accred[(size_t)w * B * HD + idx];
    acc_s[idx] = v;
  }
  __syncthreads();

  // ---- phase 5a: the new token (f32 k/v), gated by include_new --------
  for (int b = warp; b < B; b += NW) {
    float dot = 0.f;
    for (int d = lane; d < HD; d += 32) dot += q_s[b * HD + d] * kn_s[b * HD + d];
    dot = warp_sum(dot);
    if (lane == 0) {
      const float s_new = include_new[b] > 0 ? dot * scale : -1e30f;
      const float m_old = m_s[b];
      const float m_fin = fmaxf(m_old, s_new);
      const float p = expf(s_new - m_fin);
      const float corr = expf(m_old - m_fin);
      const float l_fin = l_s[b] * corr + p;
      corr_s[b] = corr;
      fp_s[b] = p;
      m_out[(size_t)b * nq + g] = m_fin;
      l_out[(size_t)b * nq + g] = l_fin;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < B * HD; idx += NT) {
    const int b = idx / HD;
    acc_s[idx] = acc_s[idx] * corr_s[b] + fp_s[b] * vn_s[idx];
  }
  __syncthreads();

  // ---- phase 5b: o[b, g, :] = acc[b, :] · wo[g] (unnormalized) --------
  const bf16* wog = wo + (size_t)g * HD * D;
  for (int n0 = tid * 4; n0 < D; n0 += NT * 4) {
    float out[B][4];
#pragma unroll
    for (int b = 0; b < B; ++b)
#pragma unroll
      for (int j = 0; j < 4; ++j) out[b][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float w[4];
      load_bf16x4(wog + (size_t)d * D + n0, w);
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const float av = acc_s[b * HD + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) out[b][j] += av * w[j];
      }
    }
#pragma unroll
    for (int b = 0; b < B; ++b)
      *reinterpret_cast<float4*>(o + ((size_t)b * nq + g) * D + n0) =
          make_float4(out[b][0], out[b][1], out[b][2], out[b][3]);
  }
}

template <int B, int HD>
int launch(const bf16* x, const bf16* wqkv, const bf16* wo, const float* ln1,
           const bf16* kc, const bf16* vc, const int* pos, const int* cache_lens,
           const int* include_new, const float* cosv, const float* sinv,
           float* o, bf16* k_new, bf16* v_new, float* m, float* l, int D, int S,
           int nq, int nkv, float scale, float eps, cudaStream_t stream) {
  const size_t smem = Smem<B, HD>::total(D);
  cudaError_t err = cudaFuncSetAttribute(
      fused_decode_kernel<B, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_decode_kernel<B, HD><<<nkv, NT, smem, stream>>>(
      x, wqkv, wo, ln1, kc, vc, pos, cache_lens, include_new, cosv, sinv, o,
      k_new, v_new, m, l, D, S, nq, nkv, scale, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_decode_launch(
    const void* x, const void* wqkv, const void* wo, const void* ln1,
    const void* kc, const void* vc, const void* pos, const void* cache_lens,
    const void* include_new, const void* cosv, const void* sinv, void* o,
    void* k_new, void* v_new, void* m, void* l, int B, int D, int S, int nq,
    int nkv, int hd, float scale, float eps, void* stream) {
  if (nq != nkv || hd != 128 || D % 4 != 0) return (int)cudaErrorInvalidValue;
#define ARGS (const bf16*)x, (const bf16*)wqkv, (const bf16*)wo, (const float*)ln1, \
    (const bf16*)kc, (const bf16*)vc, (const int*)pos, (const int*)cache_lens,        \
    (const int*)include_new, (const float*)cosv, (const float*)sinv, (float*)o,       \
    (bf16*)k_new, (bf16*)v_new, (float*)m, (float*)l, D, S, nq, nkv, scale, eps,      \
    (cudaStream_t)stream
  switch (B) {
    case 1: return launch<1, 128>(ARGS);
    case 2: return launch<2, 128>(ARGS);
    case 3: return launch<3, 128>(ARGS);
    case 4: return launch<4, 128>(ARGS);
    case 5: return launch<5, 128>(ARGS);
    case 6: return launch<6, 128>(ARGS);
    case 7: return launch<7, 128>(ARGS);
    case 8: return launch<8, 128>(ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ARGS
}
