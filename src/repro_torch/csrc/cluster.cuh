// The paper's cluster-level collectives (Alg. 1 and 2) over distributed
// shared memory, for the kernels that run one thread-block cluster per
// unit of work, and the launch that sizes the cluster: ClusterReduce
// with the sum, the flash-merge and (B3's) the top-k operator,
// ClusterGather, and the last-arrival merge of several clusters'
// partials (B2, B3).
//
// Every primitive is called by every thread of every CTA of the cluster,
// on a buffer at the same shared-memory offset in each CTA.  It starts
// with cluster.sync() (each rank's partial is written and visible) and
// ends with one (no rank overwrites its partial, or exits, while another
// still reads it).  Each output element is combined from the ranks'
// partials in rank order 0, 1, …, C−1, whichever rank computes it, so
// the result is deterministic and the same on every rank
// (repro/core/primitives.py:107-121).  No float atomics.
#pragma once

#include <cooperative_groups.h>
#include "common.cuh"

namespace cluster {

namespace cg = cooperative_groups;

// ClusterReduce, sum: out[i] = Σ_c part_c[i] for i in [begin, end)
// (multiples of 4; float4 reads).  A range of the whole buffer is an
// all-reduce; a rank's own slice is the reduce-scatter half of one
// (followed by gather()).  `out` is this CTA's own memory and must not
// alias `part`.
DEVI void sum(const float* part, float* out, int begin, int end) {
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks();
  cl.sync();
  for (int i = begin / 4 + threadIdx.x; i < end / 4; i += blockDim.x) {
    float4 x[8];
#pragma unroll
    for (int c = 0; c < 8; ++c)
      if (c < C)
        x[c] = cl.map_shared_rank(reinterpret_cast<const float4*>(part), c)[i];
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (c < C) { s.x += x[c].x; s.y += x[c].y; s.z += x[c].z; s.w += x[c].w; }
    }
    reinterpret_cast<float4*>(out)[i] = s;
  }
  cl.sync();
}

// ClusterGather: buf[i] for i in rank c's slice [c·n, (c+1)·n) (n a
// multiple of 4) is copied from rank c into every rank's `buf`, so all
// ranks end with the whole buffer.  Four float4 reads are in flight a
// thread before their stores.
DEVI void gather(float* buf, int n) {
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks(), me = (int)cl.block_rank();
  float4* b4 = reinterpret_cast<float4*>(buf);
  const int n4 = n / 4, tot = C * n4, nt = (int)blockDim.x;
  cl.sync();
  for (int i0 = threadIdx.x; i0 < tot; i0 += 4 * nt) {
    float4 x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * nt, c = i / n4;
      if (i < tot && c != me) x[u] = cl.map_shared_rank(b4, c)[i];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * nt, c = i / n4;
      if (i < tot && c != me) b4[i] = x[u];
    }
  }
  cl.sync();
}

// Where acc starts in a flash-merge partial m[R], l[R], acc[R][W]: after
// m and l, rounded up to 16 bytes for float4 reads.
__host__ __device__ constexpr int acc_offset(int R) { return (2 * R + 3) & ~3; }

// ClusterReduce with the flash-merge operator (primitives.py:266
// flash_merge) on partials laid out as m[R], l[R], acc[R][W] (acc from
// acc_offset(R)): for each
// group of four elements e .. e+3 in [begin, end) of acc (one row e / W;
// W, begin and end multiples of 4), the C partials merge in rank order
// from (m, l, acc) = (−1e30, 0, 0), and store(e, m, l, acc4) receives the
// result.  A rank with no valid row holds (−1e30, 0, 0) and leaves every
// other rank's partial unchanged; if every rank is empty the result is
// (−1e30, 0, 0).
template <typename Store>
DEVI void flash_merge(const float* part, int R, int W, int begin, int end,
                      Store store) {
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks();
  cl.sync();
  // one group of four a thread at most (the usual case): this CTA
  // arrives on the closing barrier as soon as its reads are done, and
  // merges and stores while the other ranks finish theirs
  const bool one = end - begin <= 4 * (int)blockDim.x;
  for (int e = begin + 4 * threadIdx.x; one || e < end; e += 4 * blockDim.x) {
    const bool mine = e < end;
    const int r = mine ? e / W : 0;
    // every rank's values first (their latencies overlap), then the
    // merge in rank order
    float mc[8], lc[8];
    float4 xc[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (c < C && mine) {
        const float* p = cl.map_shared_rank(const_cast<float*>(part), c);
        mc[c] = p[r];
        lc[c] = p[R + r];
        xc[c] = *reinterpret_cast<const float4*>(p + acc_offset(R) + e);
      }
    }
    if (one) cl.barrier_arrive();
    if (mine) {
      float m = -1e30f, l = 0.f;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        if (c < C) {
          const float m_new = fmaxf(m, mc[c]);
          const float ca = expf(m - m_new), cb = expf(mc[c] - m_new);
          l = l * ca + lc[c] * cb;
          acc.x = acc.x * ca + xc[c].x * cb;
          acc.y = acc.y * ca + xc[c].y * cb;
          acc.z = acc.z * ca + xc[c].z * cb;
          acc.w = acc.w * ca + xc[c].w * cb;
          m = m_new;
        }
      }
      store(e, m, l, acc);
    }
    if (one) break;
  }
  if (one) cl.barrier_wait();
  else cl.sync();
}

// ClusterReduce with the top-k operator (repro/kernels/fused_head/
// topk.py:52 topk_pair_merge): each rank holds, per slot s in
// [0, n_slots), a sorted list of K (value, index) candidates at
// pv[s·stride], pi[s·stride]; the C ranks' lists of slot s are merged by
// rank s % C, one warp a slot, into the K best under (value descending,
// ties to the lowest index), which out(s, v, i) receives as two pointers
// and warp_topk_write fills (lane 0 writes).  The operator selects and
// does no arithmetic, so the result is the same in any merge order; ranks
// are read in rank order all the same.  Indices must be unique across
// ranks (they are vocabulary rows of disjoint runs).
template <typename Out>
DEVI void topk(const float* pv, const int* pi, int n_slots, int K,
               int stride, Out out) {
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks(), me = (int)cl.block_rank();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (int)blockDim.x >> 5;
  cl.sync();
  for (int s = me + C * warp; s < n_slots; s += C * nw) {
    LaneTopK t;
    t.init();
    for (int j = lane; j < C * K; j += 32) {
      const int c = j / K, k = j % K;
      const float* rv = cl.map_shared_rank(const_cast<float*>(pv), c);
      const int* ri = cl.map_shared_rank(const_cast<int*>(pi), c);
      t.insert(rv[s * stride + k], ri[s * stride + k]);
    }
    float* ov;
    int* oi;
    out(s, ov, oi);
    warp_topk_write(t, K, ov, oi);
  }
  cl.sync();
}

// Across clusters: the last of G clusters to arrive at `counter` (an int
// in global memory, 0 between launches) runs merge(), which reads every
// cluster's partials from global memory (with __ldcg), and resets the
// counter to 0 for the next launch.  Every thread of the CTA calls it
// after writing its share of the partials; `flag` is an int in this
// CTA's shared memory.  A __threadfence before the count releases this
// CTA's partials, one after it (in the last CTA) acquires the others'.
// No float atomics: merge() combines the partials in whatever fixed
// order it chooses.
template <typename Merge>
DEVI void last_arrival(int* counter, int G, int* flag, Merge merge) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *flag = atomicAdd(counter, 1) == G - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  merge();
  if (threadIdx.x == 0) *counter = 0;
}

// Launch `kernel` on `grid` in clusters of `csize` CTAs along x
// (cudaLaunchKernelEx with cudaLaunchAttributeClusterDimension).  The
// first launch of a (kernel, shared memory, cluster size) raises the
// kernel's dynamic shared-memory limit, if it is below, to that size (the
// limit stays at the largest size launched, so a kernel launched at two
// sizes in turn stays valid at both) and asks
// cudaOccupancyMaxActiveClusters whether one cluster fits on the card; a
// cluster that cannot be scheduled returns cudaErrorInvalidConfiguration
// instead of launching.  Only power-of-two sizes up to the portable 8.
template <typename... KArgs, typename... Args>
cudaError_t launch(void (*kernel)(KArgs...), dim3 grid, int threads,
                   size_t smem, cudaStream_t stream, int csize,
                   Args... args) {
  if (csize < 1 || csize > 8 || (csize & (csize - 1)) || grid.x % csize)
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // (kernel, smem, csize) already checked: a handful per kernel
  struct Seen { const void* k; size_t smem; int csize; };
  static Seen seen[64];
  static int n_seen = 0;
  bool known = false;
  size_t limit = 0;               // the kernel's limit as set so far
  for (int i = 0; i < n_seen; ++i) {
    if (seen[i].k != (const void*)kernel) continue;
    known |= seen[i].smem == smem && seen[i].csize == csize;
    limit = seen[i].smem > limit ? seen[i].smem : limit;
  }
  if (!known) {
    cudaError_t e = cudaSuccess;
    if (smem > limit)
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    int fits = 0;
    e = cudaOccupancyMaxActiveClusters(&fits, kernel, &cfg);
    if (e != cudaSuccess) return e;
    if (fits < 1) return cudaErrorInvalidConfiguration;
    if (n_seen < 64) seen[n_seen++] = {(const void*)kernel, smem, csize};
  }
  return cudaLaunchKernelEx(&cfg, kernel, ((KArgs)args)...);
}

}  // namespace cluster

// cp.async: 16 bytes global → shared, bypassing L1, in commit groups.
DEVI void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(gmem_src));
}
// The same with `bytes` (0 or 16) read and the rest of the 16 zero-filled.
DEVI void cp_async16_zfill(void* smem_dst, const void* gmem_src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(gmem_src), "r"(bytes));
}
// 4 bytes global → shared (through L1), in the same commit groups.
DEVI void cp_async4(void* smem_dst, const void* gmem_src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(gmem_src));
}
DEVI void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
DEVI void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// TMA copies global → shared, completing on an mbarrier in the same CTA:
// one thread arms the barrier with the bytes a phase brings
// (mbar_expect_tx, which is also its one arrival) and issues the copies,
// and every reader waits for the phase's parity.
DEVI unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
DEVI void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
DEVI void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}
DEVI void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred P1;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@!P1 bra WAIT;\n}\n" ::"r"(smem_u32(bar)), "r"(parity) : "memory");
}
// The box of a 2-D tensor map (a __grid_constant__ kernel parameter) at
// coordinates (c0 inner, c1 outer) into shared memory (128-byte
// aligned), completing on the mbarrier.
DEVI void tma_2d(void* dst, const void* tmap, int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(tmap), "r"(c0), "r"(c1), "r"(smem_u32(bar)) : "memory");
}
