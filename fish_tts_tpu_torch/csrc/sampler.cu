// Slow-token sampler: repetition penalty + exact top-p + Gumbel argmax.
//
// Replaces the Pallas kernel fish_tts_tpu/ops/sampler_kernel.py::sample_slow
// (body _make_kernel, :50-104).  Per stream it
//   1. applies the penalty over the W window ids (divide positive logits,
//      multiply negative ones),
//   2. finds the top-p level set {logit >= min(hi, amax)} with hi from 40
//      bisection steps over [amax - 30, amax + 1] on the softmax mass
//      (top_p >= 1 keeps every lane),
//   3. divides by the temperature (clamped at 1e-5) and takes the argmax of
//      logits + Gumbel noise (lowest index on ties).
//
// Bound: the bytes of one read of the logits and of the noise (2 x 4 x V
// per stream).  The kernel is latency-bound, not bandwidth-bound: what
// costs is the chain of cluster-wide reductions, so the design cuts their
// number.
//
// Design.  A 155 776-lane f32 row does not fit one block's shared memory,
// so each stream gets a cluster of 8 blocks, each keeping 1/8 of the
// penalized logits and their probabilities resident.  Logits and noise are
// read from device memory once.
//  - Exchange: a block reduces its partials (recursive halving across the
//    lanes of a warp, then one warp per value), and 8 lanes store the
//    block's partials into every rank's slot (st.async, double-buffered by
//    parity), each store counted on the receiving rank's mbarrier; every
//    thread waits on its own block's mbarrier and sums the 8 local slots in
//    rank order.  No cluster-wide barrier: each block waits only for the
//    partials it reads.  Every block holds the same bits and takes the same
//    decisions; one __syncthreads per exchange.
//  - Live rows.  Once the bisection has left [lo, hi), every later mid lies
//    inside it, so mass(mid) = A + sum(p of live rows with l >= mid), with
//    A = mass{l >= hi} and the live rows those with lo <= l < hi.  Each
//    thread keeps a bit mask of its live rows, so each pass touches only
//    them.
//  - Cluster rounds: each round evaluates two bisection levels at once (the
//    three mids of the subtree, with the count of live rows at each), then
//    walks them.  Rounds run while more than kCap rows are live.
//  - Compaction: then every block writes its live rows (l, p, score l / t +
//    g, index) into rank 0's shared memory (offsets from a rank-order scan
//    of the 8 counts and a block scan of the thread counts), with its
//    argmax over the rows at or above hi, which every threshold keeps (each
//    thread scores a row as the row leaves the live set upwards).  The
//    other blocks are done.  Rank 0 runs every remaining level alone: with
//    the whole block and one __syncthreads per level while more than
//    kRegRows rows are live, then on one warp with the live rows in
//    registers, two levels per step and no barrier at all; then the argmax
//    of the kept live rows and the 8 partials.  Rows whose ties keep the
//    live set above kCap (integer-valued logits) stay on cluster rounds
//    for all 40 levels (20 rounds) and take the argmax over every lane.
//  - The max and the softmax sum share one exchange: each block sends its
//    (max, sum of exp(l - max)) and every thread rescales the 8 pairs to the
//    row's max in rank order; p is exp(l - thread max) times one scale.
//    Logits and noise are prefetched into L2 at the start, every line at
//    once.  The penalty touches only the W window lanes, one thread each.
//  - top_p >= 1 runs no max, softmax or bisection exchange at all.  The
//    argmax skips masked lanes: a masked lane scores kNeg / t + g, below
//    every kept one, and the row's max is always kept.
// No float atomics; every sum has an order fixed by rank, thread and V, so
// a stream's token does not depend on B and two calls are bit-equal.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace fts {
namespace {

constexpr int kClusterBlocks = 8;
constexpr int kSampThreads = 1024;
constexpr int kSampWarps = kSampThreads / 32;
constexpr int kPerThread = 32;      // lanes per thread at most: bits of its live mask
constexpr int kBisectIters = 40;    // sampler_kernel.BISECT_ITERS
constexpr int kMaxWindow = 64;
constexpr int kLevels = 2;          // bisection levels per cluster round
constexpr int kMids = (1 << kLevels) - 1;
constexpr int kXVals = 2 + 2 * kMids;  // a0, n0, masses at the mids, counts at the mids
constexpr int kCap = 3072;          // live rows at most that rank 0 finishes alone
constexpr int kRegRows = 128;       // live rows one warp of rank 0 keeps in registers
constexpr int kClockStamps = 9;
static_assert(kBisectIters % kLevels == 0, "a round takes kLevels whole levels");
static_assert(kMids == 3, "the walk picks one of three mids");

struct Exch {
  float v[2][kClusterBlocks][kXVals];  // [parity][source rank][value]
  float arg_v[kClusterBlocks];         // argmax partials, read by rank 0
  int arg_i[kClusterBlocks];
  float thresh;                        // rank 0: warp 0's threshold for the block
};

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Store v into `dst` of cluster rank `r` and count its 4 bytes on that
// rank's copy of the mbarrier `bar` (distributed shared memory).
__device__ __forceinline__ void store_remote(const float* dst, float v, unsigned long long* bar,
                                             int r) {
  unsigned rdst, rbar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(rdst) : "r"(smem_u32(dst)), "r"(r));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(rbar) : "r"(smem_u32(bar)), "r"(r));
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];"
               ::"r"(rdst), "f"(v), "r"(rbar)
               : "memory");
}

// Wait until this block's mbarrier completes the phase of the given parity;
// acquire at cluster scope, so the remote stores counted on it are visible.
__device__ __forceinline__ void bar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

template <bool IS_MAX>
__device__ __forceinline__ float combine(float a, float b) {
  return IS_MAX ? fmaxf(a, b) : a + b;
}

// Sum (or max) N values per lane over the warp by recursive halving: at
// each offset a lane keeps one half of its values and combines its
// partner's copy of that half, so after log2(N) offsets lane l holds value
// l >> (5 - log2 N); the remaining offsets are a butterfly.  The order is
// fixed by the lanes alone.
template <int N, bool IS_MAX>
__device__ __forceinline__ float warp_halve(float (&v)[N]) {
  const int lane = threadIdx.x & 31;
  static_assert(N == 1 || N == 2 || N == 4 || N == 8, "N must be 1, 2, 4 or 8");
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const int o = 16 >> s;
    const int m = N >> s;
    if (m > 1) {
      const bool up = lane & o;
#pragma unroll
      for (int i = 0; i < m / 2; ++i) {
        const float send = up ? v[i] : v[i + m / 2];
        const float keep = up ? v[i + m / 2] : v[i];
        v[i] = combine<IS_MAX>(keep, __shfl_xor_sync(0xffffffffu, send, o));
      }
    } else {
      v[0] = combine<IS_MAX>(v[0], __shfl_xor_sync(0xffffffffu, v[0], o));
    }
  }
  return v[0];
}

// Exchange e of the kernel (counted in `e`, the same in every thread) uses
// slot parity e & 1 and mbarrier xbar[e & 1], whose phase (e >> 1) & 1
// completes once all 8 ranks' partials have landed.  Reduce N values per
// thread over the block and send the block's partials into slot [par][rank]
// of every rank (remote stores counted on each rank's mbarrier); every
// thread then waits for its own block's slots to fill.  A
// rank writes exchange e + 2 into a slot only after it received this
// block's partials of exchange e + 1, which this block sends after reading
// the slots of exchange e: two parities suffice.  The wait also orders
// this exchange's wred reads before the next one's writes.
template <int N, bool IS_MAX>
__device__ int push_partials(float (&v)[N], float (*wred)[kXVals], Exch* ex,
                             unsigned long long* xbar, int& e, int rank) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kLog = N == 1 ? 0 : N == 2 ? 1 : N == 4 ? 2 : 3;
  const int par = e & 1;
  const unsigned phase = (e >> 1) & 1;
  ++e;
  const float w = warp_halve<N, IS_MAX>(v);
  if ((lane & ((32 >> kLog) - 1)) == 0) wred[warp][lane >> (5 - kLog)] = w;
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(smem_u32(&xbar[par])), "r"(kClusterBlocks * N * 4)
                 : "memory");
  }
  if (warp < N) {
    float t = wred[lane][warp];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t = combine<IS_MAX>(t, __shfl_xor_sync(0xffffffffu, t, o));
    if (lane < kClusterBlocks) store_remote(&ex->v[par][rank][warp], t, &xbar[par], lane);
  }
  bar_wait(&xbar[par], phase);
  return par;
}

// (max, sum of exp(l - max)) pairs merged: the larger max, each sum rescaled
// to it.  Symmetric, so both lanes of a butterfly hold the same bits.
__device__ __forceinline__ void merge_softmax(float& m, float& s, float om, float os) {
  const float M = fmaxf(m, om);
  s = s * expf(m - M) + os * expf(om - M);
  m = M;
}

__device__ __forceinline__ void warp_softmax(float& m, float& s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    merge_softmax(m, s, __shfl_xor_sync(0xffffffffu, m, o), __shfl_xor_sync(0xffffffffu, s, o));
  }
}

// Exclusive prefix of `cnt` over the threads of the block, in thread order.
__device__ int block_exclusive_scan(int cnt, int* scan) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) scan[warp] = incl;
  __syncthreads();
  int wincl = scan[lane];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, wincl, o);
    if (lane >= o) wincl += t;
  }
  const int woff = __shfl_sync(0xffffffffu, wincl, (warp + 31) & 31);
  return (warp > 0 ? woff : 0) + incl - cnt;
}

template <bool IS_MAX>
__device__ __forceinline__ float slot_total(const Exch* ex, int par, int j) {
  float acc = ex->v[par][0][j];
#pragma unroll
  for (int r = 1; r < kClusterBlocks; ++r) acc = combine<IS_MAX>(acc, ex->v[par][r][j]);
  return acc;
}

__device__ __forceinline__ void argmax_merge(float& best, int& best_i, float v, int i) {
  if (v > best || (v == best && i < best_i)) { best = v; best_i = i; }
}

// Block argmax, lowest index on ties; warp 0 ends with the block's.
__device__ void block_argmax(float& best, int& best_i, float* red_v, int* red_i) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    argmax_merge(best, best_i, __shfl_xor_sync(0xffffffffu, best, o),
                 __shfl_xor_sync(0xffffffffu, best_i, o));
  }
  if (lane == 0) { red_v[warp] = best; red_i[warp] = best_i; }
  __syncthreads();
  if (warp == 0) {
    best = red_v[lane];
    best_i = red_i[lane];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      argmax_merge(best, best_i, __shfl_xor_sync(0xffffffffu, best, o),
                   __shfl_xor_sync(0xffffffffu, best_i, o));
    }
  }
}

// The levels left after compaction, on every thread of rank 0: `buf` holds
// n rows (l, p, score, index), `live` of them in [lo, hi), and A = mass{l >= hi}.
// Returns min(hi, amax); after the register levels only warp 0 holds it.
// Counts the levels run by the whole block into `block_levels`.
__device__ float finish_levels(const float4* buf, int n, int live, int level, float lo,
                               float hi, float A, float tp, float amax, float (*lpart)[4],
                               float2* regs, int* scan, int& block_levels) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int level0 = level;
  // the whole block: per level the mass above mid and the rows on each side
  for (int par = 0; level < kBisectIters && live > kRegRows; ++level, par ^= 1) {
    const float mid = 0.5f * (lo + hi);
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    for (int i = tid; i < n; i += kSampThreads) {
      const float4 e = buf[i];
      if (e.x >= lo && e.x < hi) {
        if (e.x >= mid) { x[0] += e.y; x[1] += 1.f; } else { x[2] += 1.f; }
      }
    }
    const float w = warp_halve<4, false>(x);
    if ((lane & 7) == 0) lpart[par * kSampWarps + warp][lane >> 3] = w;
    __syncthreads();  // lpart is double-buffered by parity: one barrier per level
    float y[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = lpart[par * kSampWarps + lane][j];
    const float t = warp_halve<4, false>(y);  // every warp sums the 32 partials alike
    const float mass = A + __shfl_sync(0xffffffffu, t, 0);
    if (mass <= tp) { hi = mid; A = mass; live = (int)__shfl_sync(0xffffffffu, t, 16); }
    else { lo = mid; live = (int)__shfl_sync(0xffffffffu, t, 8); }
  }
  block_levels = level - level0;
  if (level == kBisectIters) return fminf(hi, amax);
  // the live rows into regs, in (thread, row) order, then into warp 0's registers
  int cnt = 0;
  for (int i = tid; i < n; i += kSampThreads) cnt += buf[i].x >= lo && buf[i].x < hi;
  int dst = block_exclusive_scan(cnt, scan);
  for (int i = tid; i < n; i += kSampThreads) {
    const float4 e = buf[i];
    if (e.x >= lo && e.x < hi) regs[dst++] = make_float2(e.x, e.y);
  }
  __syncthreads();
  if (warp != 0) return 0.f;
  constexpr int kPerLane = kRegRows / 32;
  float el[kPerLane], ep[kPerLane];
#pragma unroll
  for (int q = 0; q < kPerLane; ++q) {
    const int i = lane + 32 * q;
    el[q] = i < live ? regs[i].x : -FLT_MAX;  // below every mid
    ep[q] = i < live ? regs[i].y : 0.f;
  }
  // two levels per step: the three mids' sums reduced together
  for (; level + 2 <= kBisectIters; level += 2) {
    const float m0 = 0.5f * (lo + hi);
    const float mL = 0.5f * (lo + m0), mR = 0.5f * (m0 + hi);
    float cL = 0.f, c0 = 0.f, cR = 0.f;
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      const bool in = el[q] < hi;
      cL += in && el[q] >= mL ? ep[q] : 0.f;
      c0 += in && el[q] >= m0 ? ep[q] : 0.f;
      cR += in && el[q] >= mR ? ep[q] : 0.f;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      cL += __shfl_xor_sync(0xffffffffu, cL, o);
      c0 += __shfl_xor_sync(0xffffffffu, c0, o);
      cR += __shfl_xor_sync(0xffffffffu, cR, o);
    }
    const float mass0 = A + c0;
    if (mass0 <= tp) {
      hi = m0;
      const float massL = A + cL;
      if (massL <= tp) { hi = mL; A = massL; } else { lo = mL; A = mass0; }
    } else {
      lo = m0;
      const float massR = A + cR;
      if (massR <= tp) { hi = mR; A = massR; } else { lo = mR; }
    }
  }
  if (level < kBisectIters) {
    const float mid = 0.5f * (lo + hi);
    float c = 0.f;
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) c += el[q] >= mid && el[q] < hi ? ep[q] : 0.f;
    if (A + warp_sum(c) <= tp) hi = mid;
  }
  return fminf(hi, amax);
}

// Rank 0, thread 0: the token, and the counters and clock where asked for.
__device__ void finish(int* out, int* rounds_out, long long* clock, int b, int token, int rounds,
                       int live_at, int block_levels, long long* stamps) {
  out[b] = token;
  if (rounds_out != nullptr) {
    rounds_out[3 * b] = rounds;
    rounds_out[3 * b + 1] = live_at;
    rounds_out[3 * b + 2] = block_levels;
  }
  if (clock != nullptr) {
    stamps[kClockStamps - 1] = global_ns();
#pragma unroll
    for (int s = 0; s < kClockStamps; ++s) clock[b * kClockStamps + s] = stamps[s];
  }
}

__global__ void __cluster_dims__(kClusterBlocks, 1, 1) __launch_bounds__(kSampThreads)
sample_slow_kernel(const float* __restrict__ logits, const int* __restrict__ prev,
                   const float* __restrict__ gumbel, const float* __restrict__ temp,
                   const float* __restrict__ top_p, const float* __restrict__ rep,
                   int* __restrict__ out, int* __restrict__ rounds_out,
                   long long* __restrict__ clock, const unsigned char* __restrict__ skip,
                   int V, int W, int chunk) {
  // a skipped frame: every block of every cluster reads the same flag before
  // any cluster barrier or remote store and returns, writing nothing
  if (skip != nullptr && *skip) return;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  extern __shared__ __align__(16) float smem[];
  float* lv = smem;                                    // penalized logits of this block's lanes
  float* pv = smem + chunk;                            // their probabilities
  // rank 0: the compacted live rows (l, p, l / t + g, index)
  float4* buf = reinterpret_cast<float4*>(smem + ((2 * chunk + 3) & ~3));
  __shared__ Exch ex;
  __shared__ float wred[kSampWarps][kXVals];
  __shared__ int win[kMaxWindow];
  __shared__ int scan[kSampWarps];
  __shared__ float red_v[kSampWarps];
  __shared__ int red_i[kSampWarps];
  __shared__ float lpart[2 * kSampWarps][4];
  __shared__ float2 regs[kRegRows];
  __shared__ long long stamps[kClockStamps];  // thread 0's, when the clock is asked for
  // Thread 0 records the timer at mark k, and at every skipped mark before it.
  int next_mark = 0;
  auto mark = [&](int k) {
    if (clock != nullptr && tid == 0) {
      const long long t = global_ns();
      for (; next_mark <= k; ++next_mark) stamps[next_mark] = t;
    }
  };
  mark(0);

  __shared__ unsigned long long xbar[2];  // the exchanges' mbarriers, by slot parity
  if (tid == 0) {
    for (int i = 0; i < 2; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(&xbar[i])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // this block has started and its mbarriers exist: waited on before any
  // remote store
  cluster_arrive_relaxed();
  const int v0 = rank * chunk;
  const int n = min(chunk, V - v0);
  const float* row = logits + (size_t)b * V + v0;
  const float* g = gumbel + (size_t)b * V + v0;
  // every line of this block's logits and noise requested at once
  for (int off = 32 * tid; off < n; off += 32 * kSampThreads) {
    asm volatile("prefetch.global.L2 [%0];" ::"l"(row + off));
    asm volatile("prefetch.global.L2 [%0];" ::"l"(g + off));
  }
  for (int w = tid; w < W; w += kSampThreads) win[w] = prev[b * W + w];
  const float r_pen = rep[b];
  const float tp = top_p[b];
  const float t_clamped = fmaxf(temp[b], 1e-5f);
#pragma unroll 4
  for (int i = tid; i < n; i += kSampThreads) lv[i] = row[i];
  __syncthreads();
  // the penalty: thread w takes window id w unless an earlier entry holds it
  if (tid < W) {
    const int id = win[tid];
    bool first = id >= v0 && id < v0 + n;
    for (int w = 0; w < tid; ++w) first &= win[w] != id;
    if (first) {
      const float l = lv[id - v0];
      lv[id - v0] = l < 0.f ? l * r_pen : l / r_pen;
    }
  }
  __syncthreads();
  cluster_wait();  // every block of the cluster has started
  mark(1);

  float thresh = 0.5f * kNeg;  // top_p >= 1 keeps every lane
  int rounds = 0, live_at = -1, block_levels = 0;
  if (tp < 1.0f) {
    // one exchange for the max and the softmax sum; pv holds exp(l - tmax)
    float bm = -FLT_MAX, bs = 0.f;
    for (int i = tid; i < n; i += kSampThreads) bm = fmaxf(bm, lv[i]);
    const float tmax = bm;
    for (int i = tid; i < n; i += kSampThreads) {
      const float e = expf(lv[i] - tmax);
      pv[i] = e;
      bs += e;
    }
    warp_softmax(bm, bs);
    if (lane == 0) { wred[warp][0] = bm; wred[warp][1] = bs; }
    __syncthreads();
    if (tid == 0) {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   ::"r"(smem_u32(&xbar[0])), "r"(kClusterBlocks * 2 * 4)
                   : "memory");
    }
    if (warp == 0) {
      bm = wred[lane][0];
      bs = wred[lane][1];
      warp_softmax(bm, bs);
      if (lane < kClusterBlocks) {
        store_remote(&ex.v[0][rank][0], bm, &xbar[0], lane);
        store_remote(&ex.v[0][rank][1], bs, &xbar[0], lane);
      }
    }
    bar_wait(&xbar[0], 0);
    int xe = 1;  // exchanges so far
    mark(2);
    const float amax = slot_total<true>(&ex, 0, 0);
    float sum = 0.f;
#pragma unroll
    for (int r = 0; r < kClusterBlocks; ++r) sum += ex.v[0][r][1] * expf(ex.v[0][r][0] - amax);
    const float scale = expf(tmax - amax) / sum;  // p = exp(l - tmax) * scale

    float lo = amax - 30.f, hi = amax + 1.f;
    float m0 = 0.5f * (lo + hi);
    float mids[kMids] = {0.5f * (lo + m0), m0, 0.5f * (m0 + hi)};
    // the first live set [lo, hi), the mass above hi and the first round's
    // partials, in one pass; the argmax over the rows at or above hi, which
    // every threshold keeps, grows as rows leave the live set upwards
    unsigned mask = 0;
    float x[kXVals] = {};  // a0, n0, masses at the mids, counts at the mids
    float best = -FLT_MAX;
    int best_i = 0x7fffffff;
    for (int k = 0, i = tid; i < n; ++k, i += kSampThreads) {
      const float l = lv[i];
      if (l < lo) continue;
      const float p = pv[i] * scale;
      if (l >= hi) {
        x[0] += p;
        argmax_merge(best, best_i, l / t_clamped + g[i], v0 + i);
      } else {
        mask |= 1u << k;
        x[1] += 1.f;
#pragma unroll
        for (int j = 0; j < kMids; ++j) {
          if (l >= mids[j]) { x[2 + j] += p; x[2 + kMids + j] += 1.f; }
        }
      }
    }
    mark(3);

    // cluster rounds: kLevels levels each, while the live set exceeds kCap
    float A = 0.f, live = 0.f;
    float nl[kClusterBlocks];  // live rows of each rank
    int level = 0;
    while (true) {
      const int par = push_partials<kXVals, false>(x, wred, &ex, xbar, xe, rank);
      if (level == 0) {
        A = slot_total<false>(&ex, par, 0);
#pragma unroll
        for (int r = 0; r < kClusterBlocks; ++r) nl[r] = ex.v[par][r][1];
      }
      // walk the subtree: mass(mid) = A + S(mid) against the round's A
      float S[kMids];
#pragma unroll
      for (int j = 0; j < kMids; ++j) S[j] = slot_total<false>(&ex, par, 2 + j);
      int jlo = -1, jhi = kMids;  // -1: lo, kMids: hi, else the mid's index
      float A_next = A;
      int j = kMids / 2;
#pragma unroll
      for (int d = 0, step = (kMids + 1) / 4; d < kLevels; ++d, step >>= 1) {
        const float mass = A + (j == 0 ? S[0] : j == 1 ? S[1] : S[2]);
        const float mid = j == 0 ? mids[0] : j == 1 ? mids[1] : mids[2];
        if (mass <= tp) { hi = mid; A_next = mass; jhi = j; j -= step; }
        else { lo = mid; jlo = j; j += step; }
      }
      A = A_next;
      live = 0.f;
#pragma unroll
      for (int r = 0; r < kClusterBlocks; ++r) {
        const float c_lo = jlo < 0 ? nl[r] : ex.v[par][r][2 + kMids + jlo];
        const float c_hi = jhi == kMids ? 0.f : ex.v[par][r][2 + kMids + jhi];
        nl[r] = c_lo - c_hi;
        live += nl[r];
      }
      level += kLevels;
      ++rounds;
      if (live <= (float)kCap || level == kBisectIters) break;
      // the next round's partials over the rows still live
      m0 = 0.5f * (lo + hi);
      mids[0] = 0.5f * (lo + m0);
      mids[1] = m0;
      mids[2] = 0.5f * (m0 + hi);
#pragma unroll
      for (int v = 0; v < kXVals; ++v) x[v] = 0.f;
      for (unsigned m = mask; m; m &= m - 1) {
        const int k = __ffs(m) - 1;
        const int i = tid + k * kSampThreads;
        const float l = lv[i];
        if (!(l >= lo && l < hi)) {
          mask &= ~(1u << k);
          if (l >= hi) argmax_merge(best, best_i, l / t_clamped + g[i], v0 + i);
          continue;
        }
        const float p = pv[i] * scale;
#pragma unroll
        for (int jj = 0; jj < kMids; ++jj) {
          if (l >= mids[jj]) { x[2 + jj] += p; x[2 + kMids + jj] += 1.f; }
        }
      }
    }
    mark(4);

    if (level < kBisectIters) {
      // compaction: this block's argmax over the rows at or above hi, and
      // its live rows with their scores in (thread, row) order, to rank 0
      live_at = (int)live;
      int cnt = 0;
      for (unsigned m = mask; m; m &= m - 1) {
        const int k = __ffs(m) - 1;
        const int i = tid + k * kSampThreads;
        const float l = lv[i];
        if (l >= lo && l < hi) {
          ++cnt;
        } else {
          mask &= ~(1u << k);
          if (l >= hi) argmax_merge(best, best_i, l / t_clamped + g[i], v0 + i);
        }
      }
      block_argmax(best, best_i, red_v, red_i);
      if (tid == 0) {
        Exch* ex0 = cluster.map_shared_rank(&ex, 0);
        ex0->arg_v[rank] = best;
        ex0->arg_i[rank] = best_i;
      }
      mark(5);
      float roff = 0.f;
#pragma unroll
      for (int r = 0; r < kClusterBlocks; ++r) roff += r < rank ? nl[r] : 0.f;
      int dst = (int)roff + block_exclusive_scan(cnt, scan);
      float4* buf0 = cluster.map_shared_rank(buf, 0);
      for (unsigned m = mask; m; m &= m - 1) {
        const int i = tid + (__ffs(m) - 1) * kSampThreads;
        buf0[dst++] = make_float4(lv[i], pv[i] * scale, lv[i] / t_clamped + g[i],
                                  __int_as_float(v0 + i));
      }
      cluster_arrive();
      cluster_wait();
      if (rank != 0) return;  // no block touches another's shared memory from here
      mark(6);
      const float t = finish_levels(buf, live_at, live_at, level, lo, hi, A, tp, amax, lpart,
                                    regs, scan, block_levels);
      if (tid == 0) ex.thresh = t;  // warp 0 holds the threshold
      __syncthreads();
      thresh = ex.thresh;
      mark(7);
      best = -FLT_MAX;
      best_i = 0x7fffffff;
      for (int i = tid; i < live_at; i += kSampThreads) {
        const float4 e = buf[i];
        if (e.x >= thresh) argmax_merge(best, best_i, e.z, __float_as_int(e.w));
      }
      block_argmax(best, best_i, red_v, red_i);
      if (tid == 0) {
#pragma unroll
        for (int r = 0; r < kClusterBlocks; ++r) {
          argmax_merge(best, best_i, ex.arg_v[r], ex.arg_i[r]);
        }
        finish(out, rounds_out, clock, b, best_i, rounds, live_at, block_levels, stamps);
      }
      return;
    }
    thresh = fminf(hi, amax);
  }
  mark(7);

  // every lane's score against the threshold all blocks hold
  float best = -FLT_MAX;
  int best_i = 0x7fffffff;
#pragma unroll 4
  for (int i = tid; i < n; i += kSampThreads) {
    // a masked lane scores kNeg / t + g, below every kept lane (kept: l >=
    // thresh >= kNeg / 2), and the row keeps its max: skip masked lanes
    const float l = lv[i];
    if (l >= thresh) argmax_merge(best, best_i, l / t_clamped + g[i], v0 + i);
  }
  block_argmax(best, best_i, red_v, red_i);
  if (tid == 0) {
    Exch* ex0 = cluster.map_shared_rank(&ex, 0);
    ex0->arg_v[rank] = best;
    ex0->arg_i[rank] = best_i;
  }
  cluster_arrive();
  cluster_wait();  // after this only rank 0 reads shared memory, its own
  if (rank == 0 && tid == 0) {
    best = ex.arg_v[0];
    best_i = ex.arg_i[0];
    for (int r = 1; r < kClusterBlocks; ++r) argmax_merge(best, best_i, ex.arg_v[r], ex.arg_i[r]);
    finish(out, rounds_out, clock, b, best_i, rounds, live_at, block_levels, stamps);
  }
}

}  // namespace
}  // namespace fts

enum { kLogits, kPrev, kGumbel, kTemp, kTopP, kRep, kOut, kRounds, kClock, kSkip, kNumPtrs };
enum { kB, kV, kW, kNumDims };

// ptrs/dims in the order of the enums above (kRounds, kClock, kSkip may be null);
// returns a cudaError_t.
extern "C" int fts_sample_slow(void* const* ptrs, const int* dims, void* stream) {
  using namespace fts;
  const int B = dims[kB], V = dims[kV], W = dims[kW];
  const int chunk = (V + kClusterBlocks - 1) / kClusterBlocks;
  if (W > kMaxWindow || chunk > kSampThreads * kPerThread) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem =
      (size_t)((2 * chunk + 3) & ~3) * sizeof(float) + (size_t)kCap * sizeof(float4);
  static size_t smem_set = 0;  // the largest dynamic size granted so far
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        sample_slow_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  sample_slow_kernel<<<dim3(kClusterBlocks, B), kSampThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(ptrs[kLogits]), static_cast<const int*>(ptrs[kPrev]),
      static_cast<const float*>(ptrs[kGumbel]), static_cast<const float*>(ptrs[kTemp]),
      static_cast<const float*>(ptrs[kTopP]), static_cast<const float*>(ptrs[kRep]),
      static_cast<int*>(ptrs[kOut]), static_cast<int*>(ptrs[kRounds]),
      static_cast<long long*>(ptrs[kClock]), static_cast<const unsigned char*>(ptrs[kSkip]),
      V, W, chunk);
  return (int)cudaGetLastError();
}
