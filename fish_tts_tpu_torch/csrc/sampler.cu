// Slow-token sampler: repetition penalty + exact top-p + Gumbel argmax.
//
// Replaces the Pallas kernel fish_tts_tpu/ops/sampler_kernel.py::sample_slow
// (body _make_kernel, :50-104).  Per stream it
//   1. applies the penalty over the W window ids (divide positive logits,
//      multiply negative ones),
//   2. finds the top-p level set {logit >= min(hi, amax)} with hi from 40
//      bisection steps over the softmax mass (top_p >= 1 keeps every lane),
//   3. divides by the temperature (clamped at 1e-5) and takes the argmax of
//      logits + Gumbel noise (lowest index on ties).
//
// Bound: the bytes of one read of the logits and of the noise (2 x 4 x V
// per stream); the 40 bisection passes must not stream the row 40 times.
// Design: a 155 776-lane f32 row (623 KB) does not fit one block's 227 KB
// of shared memory, so each stream gets a cluster of 8 blocks (Hopper
// thread-block clusters) and each block keeps 1/8 of the penalized logits
// and their probabilities resident in its own shared memory.  Every
// reduction (max, softmax sum, bisection mass, argmax) is a block reduction
// followed by an exchange of the 8 partials through distributed shared
// memory, combined in rank order, so all 8 blocks reach identical
// bisection decisions.  Logits and noise are read from device memory once.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace fts {
namespace {

constexpr int kClusterBlocks = 8;
constexpr int kSampThreads = 1024;
constexpr int kBisectIters = 40;  // sampler_kernel.BISECT_ITERS
constexpr int kMaxWindow = 64;

struct Slots {
  float f[2];     // double-buffered float partial
  float av[2];    // argmax value
  int ai[2];      // argmax index
};

// Cluster-wide sum/max of one float per block; every thread gets the result.
template <bool IS_MAX>
__device__ float cluster_reduce(cg::cluster_group& cluster, float v, float* scratch,
                                Slots* slots, int& phase, float* bcast) {
  v = block_reduce<IS_MAX>(v, scratch);
  const int k = phase & 1;
  ++phase;
  if (threadIdx.x == 0) slots->f[k] = v;
  cluster.sync();
  if (threadIdx.x == 0) {
    float acc = cluster.map_shared_rank(slots, 0)->f[k];
    for (int r = 1; r < kClusterBlocks; ++r) {
      const float t = cluster.map_shared_rank(slots, r)->f[k];
      acc = IS_MAX ? fmaxf(acc, t) : acc + t;
    }
    *bcast = acc;
  }
  __syncthreads();
  return *bcast;
}

__global__ void __cluster_dims__(kClusterBlocks, 1, 1) __launch_bounds__(kSampThreads)
sample_slow_kernel(const float* __restrict__ logits, const int* __restrict__ prev,
                   const float* __restrict__ gumbel, const float* __restrict__ temp,
                   const float* __restrict__ top_p, const float* __restrict__ rep,
                   int* __restrict__ out, int V, int W, int chunk) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  extern __shared__ __align__(16) float smem[];
  float* lv = smem;          // penalized logits of this block's lanes
  float* pv = smem + chunk;  // their probabilities
  __shared__ float scratch[33];
  __shared__ Slots slots;
  __shared__ float bcast;
  __shared__ int win[kMaxWindow];
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  int phase = 0;

  const int v0 = rank * chunk;
  const int n = min(chunk, V - v0);
  for (int w = tid; w < W; w += kSampThreads) win[w] = prev[b * W + w];
  __syncthreads();

  const float r_pen = rep[b];
  const float* row = logits + (size_t)b * V + v0;
  float lmax = -FLT_MAX;
  for (int i = tid; i < n; i += kSampThreads) {
    float l = row[i];
    bool hit = false;
    for (int w = 0; w < W; ++w) hit |= (win[w] == v0 + i);
    if (hit) l = l < 0.f ? l * r_pen : l / r_pen;
    lv[i] = l;
    lmax = fmaxf(lmax, l);
  }
  const float amax = cluster_reduce<true>(cluster, lmax, scratch, &slots, phase, &bcast);

  float se = 0.f;
  for (int i = tid; i < n; i += kSampThreads) se += expf(lv[i] - amax);
  const float z = logf(cluster_reduce<false>(cluster, se, scratch, &slots, phase, &bcast)) + amax;
  for (int i = tid; i < n; i += kSampThreads) pv[i] = expf(lv[i] - z);

  const float tp = top_p[b];
  float lo = amax - 30.f, hi = amax + 1.f;
  for (int it = 0; it < kBisectIters; ++it) {
    const float mid = 0.5f * (lo + hi);
    float mass = 0.f;
    for (int i = tid; i < n; i += kSampThreads) mass += lv[i] >= mid ? pv[i] : 0.f;
    mass = cluster_reduce<false>(cluster, mass, scratch, &slots, phase, &bcast);
    if (mass <= tp) hi = mid; else lo = mid;
  }
  float thresh = fminf(hi, amax);
  if (tp >= 1.0f) thresh = 0.5f * kNeg;
  const float t_clamped = fmaxf(temp[b], 1e-5f);

  const float* g = gumbel + (size_t)b * V + v0;
  float best = -FLT_MAX;
  int best_i = 0x7fffffff;
  for (int i = tid; i < n; i += kSampThreads) {
    const float masked = lv[i] >= thresh ? lv[i] : kNeg;
    const float val = masked / t_clamped + g[i];
    if (val > best) { best = val; best_i = v0 + i; }
  }
  // block argmax, lowest index on ties
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, best_i, o);
    if (ov > best || (ov == best && oi < best_i)) { best = ov; best_i = oi; }
  }
  if (lane == 0) { red_v[warp] = best; red_i[warp] = best_i; }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kSampThreads / 32; ++w) {
      if (red_v[w] > best || (red_v[w] == best && red_i[w] < best_i)) {
        best = red_v[w];
        best_i = red_i[w];
      }
    }
    slots.av[0] = best;
    slots.ai[0] = best_i;
  }
  cluster.sync();
  if (rank == 0 && tid == 0) {
    for (int r = 1; r < kClusterBlocks; ++r) {
      const Slots* s = cluster.map_shared_rank(&slots, r);
      if (s->av[0] > best || (s->av[0] == best && s->ai[0] < best_i)) {
        best = s->av[0];
        best_i = s->ai[0];
      }
    }
    out[b] = best_i;
  }
  cluster.sync();  // keep every block's shared memory alive until rank 0 read it
}

}  // namespace
}  // namespace fts

enum { kLogits, kPrev, kGumbel, kTemp, kTopP, kRep, kOut, kNumPtrs };
enum { kB, kV, kW, kNumDims };

// ptrs/dims in the order of the enums above; returns a cudaError_t.
extern "C" int fts_sample_slow(void* const* ptrs, const int* dims, void* stream) {
  using namespace fts;
  const int B = dims[kB], V = dims[kV], W = dims[kW];
  if (W > kMaxWindow) return (int)cudaErrorInvalidValue;
  const int chunk = (V + kClusterBlocks - 1) / kClusterBlocks;
  const size_t smem = (size_t)2 * chunk * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(sample_slow_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  sample_slow_kernel<<<dim3(kClusterBlocks, B), kSampThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(ptrs[kLogits]), static_cast<const int*>(ptrs[kPrev]),
      static_cast<const float*>(ptrs[kGumbel]), static_cast<const float*>(ptrs[kTemp]),
      static_cast<const float*>(ptrs[kTopP]), static_cast<const float*>(ptrs[kRep]),
      static_cast<int*>(ptrs[kOut]), V, W, chunk);
  return (int)cudaGetLastError();
}
