// Device building blocks shared by the port's kernels: warp and block
// reductions, the RoPE pair rotation, and the limits the kernels share.
// The persistent kernels' own machinery is in persistent.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cfloat>
#include <stdint.h>

// Everything here has internal linkage: each .cu that includes this header
// gets its own copy of the kernels, so no two translation units register
// the same kernel symbol.
namespace fts {
namespace {

constexpr float kNeg = -1e30f;  // the Pallas kernels' mask constant (_NEG)
constexpr int kMaxBatch = 16;
constexpr int kMaxGroup = 8;       // query heads per kv head
constexpr int kMaxHeadDim = 128;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide sum or max; every thread gets the result.  `scratch` holds 33
// floats of shared memory.
template <bool IS_MAX>
__device__ float block_reduce(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  __syncthreads();  // scratch may still be read by a previous call
  v = IS_MAX ? warp_max(v) : warp_sum(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < nwarps ? scratch[lane] : (IS_MAX ? -FLT_MAX : 0.f);
    t = IS_MAX ? warp_max(t) : warp_sum(t);
    if (lane == 0) scratch[32] = t;
  }
  __syncthreads();
  return scratch[32];
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }

inline int num_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// Interleaved-pair rotation with the bf16 (cos, sin) table applied in f32.
__device__ __forceinline__ void rope_pair(float x0, float x1, const __nv_bfloat16* rope_row,
                                          int i, float* o0, float* o1) {
  const float c = __bfloat162float(rope_row[2 * i]);
  const float sn = __bfloat162float(rope_row[2 * i + 1]);
  *o0 = __fadd_rn(__fmul_rn(x0, c), -__fmul_rn(x1, sn));
  *o1 = __fadd_rn(__fmul_rn(x1, c), __fmul_rn(x0, sn));
}

}  // namespace
}  // namespace fts
