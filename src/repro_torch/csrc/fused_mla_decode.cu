// B4 — fused MLA decode with weight absorption (paper Alg. 4): RMSNorm +
// Q-Projection + KV down-projection + K-up absorption + RoPE + ragged flash
// decode in latent space + the folded value-up/Output-Projection
// ("partial_o" through wproj = W_UV·W_O), for all B slots.  One C entry,
// five device launches: each stage needs the one before it across the
// whole grid.
//
// Replaces repro/kernels/fused_mla_decode/fused_mla_decode.py:
// fused_mla_decode_attention (the Pallas kernel at its pallas_call, line
// 261) in the serving mode of core/dataflow.py:_mla_attention_pallas_packed:
// fuse_out="partial_o", fused ln1, linear latent cache with per-slot pos,
// include_new from the append rule, pos_base = 0.
//
// Bound on an H100: bytes.  At DeepSeek-V2-Lite widths a layer reads wq
// (12.6 MB), wdkv (2.4 MB), wuk (2.1 MB) and wproj (33.6 MB, 61 % of the
// layer's bytes) once for all slots, plus each slot's live latent rows
// (1152 bytes a position, shared by all 16 heads), at a few FLOPs per
// byte.  The TPU path vmapped the kernel per slot and so re-read every
// weight B times; here every stage keeps B accumulators per weight column.
//   1. mla_proj_kernel: RMSNorm(x, ln1) for all slots into shared memory,
//      rounded to bf16 as the Pallas kernel's fuse_norm branch (line 69);
//      then the 3648 columns of wq|wdkv, 32 columns a block (114 blocks),
//      f32 results to a workspace.
//   2. mla_qlat_kernel: q_lat = q_nope · wuk[h], one head and 128 latent
//      columns a block; RoPE on q_rope (f32) and on c_rope; writes the new
//      latent entry c_new rounded to the cache dtype.
//   3. mla_attn_kernel: flash decoding, one block per (slot, 64-position
//      chunk of the slot's live prefix): the chunk's latent rows are read
//      once into shared memory and serve all heads; scores over l + rope,
//      values c[:, :l]; per-chunk (m, l, acc) to the workspace.  A free slot
//      (cache_len < 0) reads no cache.
//      mla_merge_kernel: merges the chunks in order (one block per (head,
//      slot)), then folds in the new token read back ROUNDED from c_new
//      (the Pallas kernel's line 146), gated by include_new; m starts at
//      -1e30, so a free slot ends with l = 1 and acc = c_new[:l].
//   4. mla_out_kernel: o[b, h, :] = acc[b, h, :] · wproj[h], streaming wproj
//      once (128 output columns of one head a block), unnormalized f32.
// Later work: the paper's DSMEM ClusterReduce redesign (one thread-block
// cluster per head group merging (m, l, o) in distributed shared memory,
// no workspace round trips), and reading wuv + wo (6.3 MB a layer) in
// place of the 33.6 MB fold at cluster size 1.
#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int NW = NT / 32;
constexpr int TC = 32;               // stage 1: wq|wdkv columns per block
constexpr int DP1 = NT / (TC / 4);   // stage 1: D partitions
constexpr int LT = 128;              // stage 2: latent columns per block
constexpr int NP2 = NT / (LT / 4);   // stage 2: nope partitions
constexpr int CH = 64;               // stage 3: positions per chunk
constexpr int MAXQ = 16;             // heads held in registers (stage 3)
constexpr int NT3 = 128;             // stage 3 merge: threads per block
constexpr int TD = 128;              // stage 4: output columns per block
constexpr int JP4 = NT / (TD / 4);   // stage 4: latent partitions

// f32 workspace, in floats (every section a multiple of 4 floats)
struct Workspace {
  int B, S, nq, nope, rope, l;
  __host__ __device__ int pq() const { return nq * (nope + rope); }
  __host__ __device__ int lr() const { return l + rope; }
  __host__ __device__ int p1() const { return pq() + lr(); }
  __host__ __device__ int ns() const { return (S + CH - 1) / CH; }
  // [B][p1]: x_normed · (wq | wdkv)
  __host__ __device__ size_t proj() const { return 0; }
  // [B][nq][l + rope]: q_lat | rotated q_rope
  __host__ __device__ size_t qf() const { return proj() + (size_t)B * p1(); }
  // [B][ns][nq]: per-chunk max and sum
  __host__ __device__ size_t pm() const { return qf() + (size_t)B * nq * lr(); }
  __host__ __device__ size_t pl() const { return pm() + (size_t)B * ns() * nq; }
  // [B][ns][nq][l]: per-chunk unnormalized accumulators
  __host__ __device__ size_t pacc() const { return pl() + (size_t)B * ns() * nq; }
  // [B][nq][l]: merged accumulators, new token included
  __host__ __device__ size_t acc() const { return pacc() + (size_t)B * ns() * nq * l; }
  __host__ __device__ size_t total() const { return acc() + (size_t)B * nq * l; }
};

// ---- stage 1 --------------------------------------------------------------
template <int B>
__host__ __device__ size_t smem1(int D) {
  return (size_t)B * D * 2 + (size_t)DP1 * B * TC * 4 + (size_t)33 * B * 4;
}

template <int B>
__global__ void __launch_bounds__(NT)
mla_proj_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wq,
                const bf16* __restrict__ wdkv, const float* __restrict__ ln1,
                float* __restrict__ proj, int D, int Pq, int LR, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  float* red = reinterpret_cast<float*>(smem + (size_t)B * D * 2);
  float* red2 = red + DP1 * B * TC;
  const int tid = threadIdx.x;
  const int P1 = Pq + LR;

  rms_rows_to_smem<B>(x, nullptr, ln1, D, eps, xs, red2);

  const int quad = tid % (TC / 4), dpart = tid / (TC / 4);
  const int c = blockIdx.x * TC + quad * 4;
  float acc[B][4];
#pragma unroll
  for (int b = 0; b < B; ++b)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[b][j] = 0.f;
  if (c < P1) {
    // a quad never straddles wq and wdkv: Pq is a multiple of 4
    const bf16* wp = c < Pq ? wq + c : wdkv + (c - Pq);
    const int stride = c < Pq ? Pq : LR;
#pragma unroll 4
    for (int d = dpart; d < D; d += DP1) {
      float w[4];
      load_bf16x4(wp + (size_t)d * stride, w);
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const float xv = bf2f(xs[b * D + d]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[b][j] += xv * w[j];
      }
    }
  }
#pragma unroll
  for (int b = 0; b < B; ++b)
    *reinterpret_cast<float4*>(red + ((size_t)dpart * B + b) * TC + quad * 4) =
        make_float4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]);
  __syncthreads();
  for (int idx = tid; idx < B * TC; idx += NT) {
    const int b = idx / TC, cc = idx % TC, col = blockIdx.x * TC + cc;
    if (col >= P1) continue;
    float v = 0.f;
    for (int dp = 0; dp < DP1; ++dp) v += red[((size_t)dp * B + b) * TC + cc];
    proj[(size_t)b * P1 + col] = v;
  }
}

// ---- stage 2 --------------------------------------------------------------
template <int B>
__host__ __device__ size_t smem2(int nope) {
  return (size_t)B * nope * 4 + (size_t)NP2 * B * LT * 4;
}

template <int B>
__global__ void __launch_bounds__(NT)
mla_qlat_kernel(const float* __restrict__ proj, const bf16* __restrict__ wuk,
                const float* __restrict__ cosv, const float* __restrict__ sinv,
                float* __restrict__ qf, bf16* __restrict__ c_new, int nq,
                int nope, int rope, int l) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qn = reinterpret_cast<float*>(smem);            // [B][nope]
  float* red = qn + B * nope;                            // [NP2][B][LT]
  const int tid = threadIdx.x, h = blockIdx.y, j0 = blockIdx.x * LT;
  const int hr = nope + rope, Pq = nq * hr, LR = l + rope, P1 = Pq + LR;
  const int half = rope / 2;

  for (int i = tid; i < B * nope; i += NT) {
    const int b = i / nope, n = i % nope;
    qn[i] = proj[(size_t)b * P1 + h * hr + n];
  }
  __syncthreads();

  // q_lat[b, h, j] = sum_n q_nope[b, h, n] · wuk[h, n, j]
  const int quad = tid % (LT / 4), np = tid / (LT / 4);
  const int j = j0 + quad * 4;
  float acc[B][4];
#pragma unroll
  for (int b = 0; b < B; ++b)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[b][k] = 0.f;
  if (j < l) {
    const bf16* wp = wuk + (size_t)h * nope * l + j;
#pragma unroll 4
    for (int n = np; n < nope; n += NP2) {
      float w[4];
      load_bf16x4(wp + (size_t)n * l, w);
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const float qv = qn[b * nope + n];
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[b][k] += qv * w[k];
      }
    }
  }
#pragma unroll
  for (int b = 0; b < B; ++b)
    *reinterpret_cast<float4*>(red + ((size_t)np * B + b) * LT + quad * 4) =
        make_float4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]);
  __syncthreads();
  for (int idx = tid; idx < B * LT; idx += NT) {
    const int b = idx / LT, cc = idx % LT;
    if (j0 + cc >= l) continue;
    float v = 0.f;
    for (int p = 0; p < NP2; ++p) v += red[((size_t)p * B + b) * LT + cc];
    qf[((size_t)b * nq + h) * LR + j0 + cc] = v;
  }

  if (blockIdx.x != 0) return;
  // RoPE (rotate halves) on this head's q_rope, in f32
  for (int idx = tid; idx < B * half; idx += NT) {
    const int b = idx / half, i = idx % half;
    const float c = cosv[b * half + i], s = sinv[b * half + i];
    const float* t = proj + (size_t)b * P1 + h * hr + nope;
    const float t1 = t[i], t2 = t[i + half];
    float* out = qf + ((size_t)b * nq + h) * LR + l;
    out[i] = t1 * c - t2 * s;
    out[i + half] = t2 * c + t1 * s;
  }
  if (h != 0) return;
  // the new latent entry [c_lat | RoPE(c_rope)], rounded to the cache dtype
  for (int idx = tid; idx < B * LR; idx += NT) {
    const int b = idx / LR, k = idx % LR;
    const float* t = proj + (size_t)b * P1 + Pq;
    float v;
    if (k < l) {
      v = t[k];
    } else {
      const int i = (k - l) % half;
      const float c = cosv[b * half + i], s = sinv[b * half + i];
      const float t1 = t[l + i], t2 = t[l + half + i];
      v = k - l < half ? t1 * c - t2 * s : t2 * c + t1 * s;
    }
    c_new[idx] = f2bf(v);
  }
}

// ---- stage 3: flash decoding over live chunks, then the in-order merge ----
__host__ __device__ size_t smem3(int nq, int LR) {
  return (size_t)nq * LR * 4 + (size_t)CH * (LR + 8) * 2 + (size_t)nq * CH * 4
       + (size_t)CH * 4;
}

__global__ void __launch_bounds__(NT)
mla_attn_kernel(const bf16* __restrict__ cache, const int* __restrict__ pos,
                const int* __restrict__ cache_lens, const float* __restrict__ qf,
                float* __restrict__ pm, float* __restrict__ pl,
                float* __restrict__ pacc, int B, int S, int nq, int l, int rope,
                float scale) {
  const int c = blockIdx.x, b = blockIdx.y, ns = gridDim.x;
  const int cl = cache_lens[b];
  const int Lb = cl < 0 ? 0 : (cl < S ? cl : S);
  const int s0 = c * CH;
  if (s0 >= Lb) return;                    // beyond the live prefix: no reads
  const int n = Lb - s0 < CH ? Lb - s0 : CH;
  const int LR = l + rope, LRP = LR + 8;   // padded rows: no bank conflicts
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);                        // [nq][LR]
  bf16* cs = reinterpret_cast<bf16*>(smem + (size_t)nq * LR * 4);    // [CH][LRP]
  float* ps = reinterpret_cast<float*>(cs + (size_t)CH * LRP);       // [nq][CH]
  int* ok = reinterpret_cast<int*>(ps + nq * CH);                    // [CH]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const float4* qsrc = reinterpret_cast<const float4*>(qf + (size_t)b * nq * LR);
  for (int i = tid; i < nq * LR / 4; i += NT)
    reinterpret_cast<float4*>(qs)[i] = qsrc[i];
  // slot b's rows sit at a stride of B·(l + rope) elements
  const int V8 = LR / 8;
  for (int i = tid; i < n * V8; i += NT) {
    const int p = i / V8, v = i % V8;
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(
        cache + ((size_t)(s0 + p) * B + b) * LR) + v);
    *reinterpret_cast<uint4*>(cs + (size_t)p * LRP + v * 8) = u;
  }
  for (int p = tid; p < CH; p += NT) {
    int valid = 0;
    if (p < n) {
      const int ps_ = pos[(size_t)(s0 + p) * B + b];
      valid = ps_ >= 0 && ps_ < cl;
    }
    ok[p] = valid;
  }
  __syncthreads();

  // scores: one position and four heads a thread
  {
    const int p = tid % CH;
    for (int hq = tid / CH; hq < nq / 4; hq += NT / CH) {
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      if (ok[p]) {
        const bf16* cr = cs + (size_t)p * LRP;
        const float* q0 = qs + (size_t)4 * hq * LR;
        for (int k = 0; k < LR; k += 8) {
          float cv[8];
          smem_bf16x8(cr + k, cv);
#pragma unroll
          for (int hh = 0; hh < 4; ++hh) {
            const float4 qa = *reinterpret_cast<const float4*>(q0 + hh * LR + k);
            const float4 qb = *reinterpret_cast<const float4*>(q0 + hh * LR + k + 4);
            d[hh] += qa.x * cv[0] + qa.y * cv[1] + qa.z * cv[2] + qa.w * cv[3]
                   + qb.x * cv[4] + qb.y * cv[5] + qb.z * cv[6] + qb.w * cv[7];
          }
        }
      }
#pragma unroll
      for (int hh = 0; hh < 4; ++hh)
        ps[(4 * hq + hh) * CH + p] = ok[p] ? d[hh] * scale : -INFINITY;
    }
  }
  __syncthreads();
  // chunk softmax statistics, one warp per head; -1e30 floors m as the
  // Pallas kernel's masked scores do
  for (int h = warp; h < nq; h += NW) {
    float mx = -1e30f;
    for (int p = lane; p < CH; p += 32) mx = fmaxf(mx, ps[h * CH + p]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int p = lane; p < CH; p += 32) {
      const float sv = ps[h * CH + p];
      const float e = sv == -INFINITY ? 0.f : expf(sv - mx);
      ps[h * CH + p] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      pm[((size_t)b * ns + c) * nq + h] = mx;
      pl[((size_t)b * ns + c) * nq + h] = sum;
    }
  }
  __syncthreads();
  // P·V over the latent values c[:, :l]: two columns a thread, all heads
  for (int j = 2 * tid; j < l; j += 2 * NT) {
    float a0[MAXQ], a1[MAXQ];
#pragma unroll
    for (int h = 0; h < MAXQ; ++h) { a0[h] = 0.f; a1[h] = 0.f; }
    for (int p = 0; p < n; ++p) {
      const uint32_t u = *reinterpret_cast<const uint32_t*>(cs + (size_t)p * LRP + j);
      const float c0 = lo_bf(u), c1 = hi_bf(u);
#pragma unroll
      for (int h = 0; h < MAXQ; ++h) {
        if (h < nq) {
          const float pv = ps[h * CH + p];
          a0[h] += pv * c0;
          a1[h] += pv * c1;
        }
      }
    }
#pragma unroll
    for (int h = 0; h < MAXQ; ++h)
      if (h < nq)
        *reinterpret_cast<float2*>(pacc + (((size_t)b * ns + c) * nq + h) * l + j) =
            make_float2(a0[h], a1[h]);
  }
}

__global__ void __launch_bounds__(NT3)
mla_merge_kernel(const float* __restrict__ qf, const bf16* __restrict__ c_new,
                 const int* __restrict__ cache_lens,
                 const int* __restrict__ include_new,
                 const float* __restrict__ pm, const float* __restrict__ pl,
                 const float* __restrict__ pacc, float* __restrict__ acc_out,
                 float* __restrict__ m_out, float* __restrict__ l_out, int S,
                 int nq, int l, int rope, float scale) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int LR = l + rope, ns = (S + CH - 1) / CH;
  const int cl = cache_lens[b];
  const int Lb = cl < 0 ? 0 : (cl < S ? cl : S);
  const int nchunks = (Lb + CH - 1) / CH;
  __shared__ float red[NT3 / 32];

  // the new token's score, against the entry read back in the cache dtype
  const float* q = qf + ((size_t)b * nq + h) * LR;
  const bf16* cn = c_new + (size_t)b * LR;
  float dot = 0.f;
  for (int k = tid; k < LR; k += NT3) dot += q[k] * bf2f(cn[k]);
  dot = warp_sum(dot);
  if (lane == 0) red[warp] = dot;
  __syncthreads();
  dot = 0.f;
  for (int w = 0; w < NT3 / 32; ++w) dot += red[w];
  const float s_new = include_new[b] > 0 ? dot * scale : -1e30f;

  const size_t st = (size_t)b * ns * nq + h;     // chunk c at st + c·nq
  for (int j = tid; j < l; j += NT3) {
    float m = -1e30f, lsum = 0.f, a = 0.f;
    for (int c = 0; c < nchunks; ++c) {
      const float mc = pm[st + (size_t)c * nq];
      const float m_new = fmaxf(m, mc);
      const float corr = expf(m - m_new), cc = expf(mc - m_new);
      lsum = lsum * corr + pl[st + (size_t)c * nq] * cc;
      a = a * corr + pacc[(st + (size_t)c * nq) * l + j] * cc;
      m = m_new;
    }
    const float m_fin = fmaxf(m, s_new);
    const float p = expf(s_new - m_fin), corr = expf(m - m_fin);
    acc_out[((size_t)b * nq + h) * l + j] = a * corr + p * bf2f(cn[j]);
    if (j == 0) {
      m_out[(size_t)b * nq + h] = m_fin;
      l_out[(size_t)b * nq + h] = lsum * corr + p;
    }
  }
}

// ---- stage 4 --------------------------------------------------------------
template <int B>
__host__ __device__ size_t smem4(int l) {
  return (size_t)B * l * 4 + (size_t)JP4 * B * TD * 4;
}

template <int B>
__global__ void __launch_bounds__(NT)
mla_out_kernel(const float* __restrict__ acc_in, const bf16* __restrict__ wproj,
               float* __restrict__ o, int D, int nq, int l) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* as = reinterpret_cast<float*>(smem);          // [B][l]
  float* red = as + B * l;                             // [JP4][B][TD]
  const int tid = threadIdx.x, h = blockIdx.y;
  for (int i = tid; i < B * l; i += NT) {
    const int b = i / l, j = i % l;
    as[i] = acc_in[((size_t)b * nq + h) * l + j];
  }
  __syncthreads();
  const int quad = tid % (TD / 4), jp = tid / (TD / 4);
  const int n0 = blockIdx.x * TD + quad * 4;
  float acc[B][4];
#pragma unroll
  for (int b = 0; b < B; ++b)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[b][k] = 0.f;
  if (n0 < D) {
    const bf16* wp = wproj + (size_t)h * l * D + n0;
#pragma unroll 8
    for (int j = jp; j < l; j += JP4) {
      float w[4];
      load_bf16x4(wp + (size_t)j * D, w);
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const float av = as[b * l + j];
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[b][k] += av * w[k];
      }
    }
  }
#pragma unroll
  for (int b = 0; b < B; ++b)
    *reinterpret_cast<float4*>(red + ((size_t)jp * B + b) * TD + quad * 4) =
        make_float4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]);
  __syncthreads();
  for (int idx = tid; idx < B * TD; idx += NT) {
    const int b = idx / TD, cc = idx % TD, n = blockIdx.x * TD + cc;
    if (n >= D) continue;
    float v = 0.f;
    for (int p = 0; p < JP4; ++p) v += red[((size_t)p * B + b) * TD + cc];
    o[((size_t)b * nq + h) * D + n] = v;
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

#define CHECK_CUDA(expr)                      \
  do {                                        \
    cudaError_t e_ = (expr);                  \
    if (e_ != cudaSuccess) return (int)e_;    \
  } while (0)

template <int B>
int launch(const bf16* x, const bf16* wq, const bf16* wdkv, const bf16* wuk,
           const bf16* wproj, const float* ln1, const bf16* cache, const int* pos,
           const int* cache_lens, const int* include_new, const float* cosv,
           const float* sinv, float* ws, float* o, bf16* c_new, float* m,
           float* l_out, int D, int S, int nq, int nope, int rope, int l,
           float scale, float eps, cudaStream_t stream) {
  const Workspace w{B, S, nq, nope, rope, l};
  float* proj = ws + w.proj();
  float* qf = ws + w.qf();
  float* pm = ws + w.pm();
  float* pl = ws + w.pl();
  float* pacc = ws + w.pacc();
  float* acc = ws + w.acc();
  const int LR = l + rope;

  const size_t s1 = smem1<B>(D);
  CHECK_CUDA(allow_smem(mla_proj_kernel<B>, s1));
  mla_proj_kernel<B><<<(w.p1() + TC - 1) / TC, NT, s1, stream>>>(
      x, wq, wdkv, ln1, proj, D, w.pq(), LR, eps);
  CHECK_CUDA(cudaGetLastError());

  const size_t s2 = smem2<B>(nope);
  CHECK_CUDA(allow_smem(mla_qlat_kernel<B>, s2));
  mla_qlat_kernel<B><<<dim3((l + LT - 1) / LT, nq), NT, s2, stream>>>(
      proj, wuk, cosv, sinv, qf, c_new, nq, nope, rope, l);
  CHECK_CUDA(cudaGetLastError());

  const size_t s3 = smem3(nq, LR);
  CHECK_CUDA(allow_smem(mla_attn_kernel, s3));
  mla_attn_kernel<<<dim3(w.ns(), B), NT, s3, stream>>>(
      cache, pos, cache_lens, qf, pm, pl, pacc, B, S, nq, l, rope, scale);
  CHECK_CUDA(cudaGetLastError());
  mla_merge_kernel<<<dim3(nq, B), NT3, 0, stream>>>(
      qf, c_new, cache_lens, include_new, pm, pl, pacc, acc, m, l_out, S, nq,
      l, rope, scale);
  CHECK_CUDA(cudaGetLastError());

  const size_t s4 = smem4<B>(l);
  CHECK_CUDA(allow_smem(mla_out_kernel<B>, s4));
  mla_out_kernel<B><<<dim3((D + TD - 1) / TD, nq), NT, s4, stream>>>(
      acc, wproj, o, D, nq, l);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_mla_decode_workspace(int B, int S, int nq, int nope,
                                          int rope, int l) {
  const Workspace w{B, S, nq, nope, rope, l};
  return (int)w.total();
}

extern "C" int fused_mla_decode_launch(
    const void* x, const void* wq, const void* wdkv, const void* wuk,
    const void* wproj, const void* ln1, const void* cache, const void* pos,
    const void* cache_lens, const void* include_new, const void* cosv,
    const void* sinv, void* ws, void* o, void* c_new, void* m, void* l_out,
    int B, int D, int S, int nq, int nope, int rope, int l, float scale,
    float eps, void* stream) {
  if (nq % 4 != 0 || nq > MAXQ || (l + rope) % 8 != 0 || l % 8 != 0 ||
      nope % 4 != 0 || rope % 2 != 0 || D % 8 != 0)
    return (int)cudaErrorInvalidValue;
#define ARGS (const bf16*)x, (const bf16*)wq, (const bf16*)wdkv, (const bf16*)wuk,   \
    (const bf16*)wproj, (const float*)ln1, (const bf16*)cache, (const int*)pos,      \
    (const int*)cache_lens, (const int*)include_new, (const float*)cosv,             \
    (const float*)sinv, (float*)ws, (float*)o, (bf16*)c_new, (float*)m,              \
    (float*)l_out, D, S, nq, nope, rope, l, scale, eps, (cudaStream_t)stream
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
