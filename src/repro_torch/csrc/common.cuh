// Helpers shared by the port's hand-written Hopper kernels.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define DEVI __device__ __forceinline__

// bf16 <-> f32.  f2bf rounds to nearest even, as astype(bfloat16) does.
DEVI float bf2f(bf16 v) { return __bfloat162float(v); }
DEVI bf16 f2bf(float v) { return __float2bfloat16(v); }
DEVI float round_bf(float v) { return __bfloat162float(__float2bfloat16(v)); }

// Two packed bf16 (low half first) -> two f32, exactly.
DEVI float lo_bf(uint32_t u) { return __uint_as_float(u << 16); }
DEVI float hi_bf(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// 4 consecutive bf16 from an 8-byte aligned address.
DEVI void load_bf16x4(const bf16* p, float out[4]) {
  uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  out[0] = lo_bf(u.x); out[1] = hi_bf(u.x);
  out[2] = lo_bf(u.y); out[3] = hi_bf(u.y);
}

// 8 consecutive bf16 from a 16-byte aligned address (global memory).
DEVI void load_bf16x8(const bf16* p, float out[8]) {
  uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  out[0] = lo_bf(u.x); out[1] = hi_bf(u.x);
  out[2] = lo_bf(u.y); out[3] = hi_bf(u.y);
  out[4] = lo_bf(u.z); out[5] = hi_bf(u.z);
  out[6] = lo_bf(u.w); out[7] = hi_bf(u.w);
}

// 4 consecutive bf16 from an 8-byte aligned shared-memory address.
DEVI void load_bf16x4_smem(const bf16* p, float out[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  out[0] = lo_bf(u.x); out[1] = hi_bf(u.x);
  out[2] = lo_bf(u.y); out[3] = hi_bf(u.y);
}

// 8 consecutive bf16 from a 16-byte aligned shared-memory address.
DEVI void smem_bf16x8(const bf16* p, float out[8]) {
  uint4 u = *reinterpret_cast<const uint4*>(p);
  out[0] = lo_bf(u.x); out[1] = hi_bf(u.x);
  out[2] = lo_bf(u.y); out[3] = hi_bf(u.y);
  out[4] = lo_bf(u.z); out[5] = hi_bf(u.z);
  out[6] = lo_bf(u.w); out[7] = hi_bf(u.w);
}

// ---------------------------------------------------------------------------
// Tensor cores: mma.sync m16n8k16, bf16 in, f32 accumulate (exact products
// summed in f32), and the fragments it takes.
// ---------------------------------------------------------------------------
DEVI void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

DEVI uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two f32 as packed bf16 hi terms and lo terms: x = hi + lo to ~2^-17.
DEVI void split_bf16(float2 x, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x.x - __low2float(h),
                                                 x.y - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// ldmatrix .trans of 8x8 bf16 blocks of a row-major [k][n] tile: the B
// fragments (k-pairs) of mma m16n8k16.
DEVI void ldsm_x4_t(const bf16* p, uint32_t r[4]) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
DEVI void ldsm_x2_t(const bf16* p, uint32_t r[2]) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(a));
}

DEVI float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

DEVI float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// RMSNorm of B rows into shared memory, rounded to bf16 — the
// reference's rms_norm: x * (1/sqrt(mean(x^2) + eps)) * (1 + scale), in
// f32, cast back to the model dtype.  With `a` non-null the rows are
// first r = bf16(x + a) (the fused FFN's residual add).  `red` is
// shared scratch of at least 32*B + B floats.  Ends with a barrier.
template <int B>
__device__ void rms_rows_to_smem(const bf16* __restrict__ x,
                                 const bf16* __restrict__ a,
                                 const float* __restrict__ scale, int D,
                                 float eps, bf16* out, float* red) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  float ss[B];
#pragma unroll
  for (int b = 0; b < B; ++b) ss[b] = 0.f;
  for (int d = tid; d < D; d += nt) {
#pragma unroll
    for (int b = 0; b < B; ++b) {
      float v = bf2f(x[(size_t)b * D + d]);
      if (a != nullptr) v = round_bf(v + bf2f(a[(size_t)b * D + d]));
      ss[b] += v * v;
      out[b * D + d] = f2bf(v);
    }
  }
#pragma unroll
  for (int b = 0; b < B; ++b) {
    float s = warp_sum(ss[b]);
    if (lane == 0) red[warp * B + b] = s;
  }
  __syncthreads();
  float* inv = red + 32 * B;
  if (tid < B) {
    float s = 0.f;
    for (int w = 0; w < nw; ++w) s += red[w * B + tid];
    inv[tid] = 1.0f / sqrtf(s / (float)D + eps);
  }
  __syncthreads();
  for (int d = tid; d < D; d += nt) {
    const float g = 1.0f + scale[d];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      float v = bf2f(out[b * D + d]);
      out[b * D + d] = f2bf(v * inv[b] * g);
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Top-k under the reference's total order: value descending, ties to the
// LOWEST index.  Each lane keeps a sorted list of its best MAXK
// candidates in registers; a warp then pops the global best K.
// ---------------------------------------------------------------------------
#define TOPK_MAXK 8
#define INT32_MAX_ 2147483647

DEVI bool topk_better(float v1, int i1, float v2, int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

struct LaneTopK {
  float v[TOPK_MAXK];
  int i[TOPK_MAXK];

  DEVI void init() {
#pragma unroll
    for (int k = 0; k < TOPK_MAXK; ++k) { v[k] = -INFINITY; i[k] = INT32_MAX_; }
  }

  DEVI void insert(float nv, int ni) {
    if (!topk_better(nv, ni, v[TOPK_MAXK - 1], i[TOPK_MAXK - 1])) return;
    v[TOPK_MAXK - 1] = nv; i[TOPK_MAXK - 1] = ni;
#pragma unroll
    for (int k = TOPK_MAXK - 1; k > 0; --k) {
      if (topk_better(v[k], i[k], v[k - 1], i[k - 1])) {
        float tv = v[k]; v[k] = v[k - 1]; v[k - 1] = tv;
        int ti = i[k]; i[k] = i[k - 1]; i[k - 1] = ti;
      }
    }
  }

  DEVI void pop() {
#pragma unroll
    for (int k = 0; k < TOPK_MAXK - 1; ++k) { v[k] = v[k + 1]; i[k] = i[k + 1]; }
    v[TOPK_MAXK - 1] = -INFINITY; i[TOPK_MAXK - 1] = INT32_MAX_;
  }
};

// The warp's K best over every lane's list, written by lane 0 to
// out_v[k*stride] / out_i[k*stride]; indices are unique except for the
// (-inf, INT32_MAX) padding.
DEVI void warp_topk_write(LaneTopK& t, int K, float* out_v, int* out_i) {
  const int lane = threadIdx.x & 31;
  for (int k = 0; k < K; ++k) {
    float bv = t.v[0];
    int bi = t.i[0];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (topk_better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
    }
    if (lane == 0) { out_v[k] = bv; out_i[k] = bi; }
    if (t.v[0] == bv && t.i[0] == bi) t.pop();
  }
}
