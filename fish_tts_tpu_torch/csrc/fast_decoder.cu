// Fast-codebook decoder: the per-frame loop over the K codebook positions.
//
// Replaces the Pallas kernel fish_tts_tpu/ops/fast_decoder.py
// ::_fast_decode_frame (body _make_kernel :116-428, "value" dequant mode).
// Position 0 runs the fast layers on the projected slow hidden state and
// only fills the per-frame K/V cache.  Each position cb = 1..K-1 embeds the
// previous code (int8 row x row scale), runs the layers with causal
// attention over the positions so far, applies fast_norm and the head over
// the first Vr rows of fast_output, then the repetition penalty over the
// stream's window row cb-1, the exact sort-free top-p (i is kept iff
// sum(p_j : l_j > l_i) + p_i <= top_p, or i is the argmax, or top_p >= 1),
// temperature, and the Gumbel argmax.
//
// Bound: bytes.  At S1-mini width the four int8 layers are 63 MB, read once
// per position: 10 x 63 MB per frame, since 63 MB does not stay in the 50 MB
// L2 the way the Pallas kernel keeps the stack in VMEM.  Design: one host
// loop launches, per position, an embedding gather, five launches per layer
// (the same qgemv and decode-attention kernels as the slow stack, with an
// f32 per-frame cache of K rows), the head qgemv and one sampling block per
// stream that holds the Vr logits and probabilities in shared memory for
// the Vr x Vr pairwise top-p comparison.
#include "common.cuh"

enum {
  kH, kA0, kPrev, kGumbel, kTemp, kTopP, kRep, kRope,
  kAttnNorm, kFfnNorm, kWqkv, kWqkvS, kWo, kWoS, kW1, kW1S, kW3, kW3S, kW2, kW2S,
  kFastNorm, kHead, kHeadS, kEmb, kEmbS, kCodes, kLogitsOut,
  kXBuf, kQkvBuf, kOBuf, kHBuf, kKCache, kVCache, kHeadBuf, kCodeBuf, kNumPtrs
};
enum { kB, kK, kL, kD, kHeads, kHkv, kDh, kI, kVr, kW, kNumDims };

namespace fts {
namespace {

constexpr int kFastSampThreads = 1024;
constexpr int kMaxWindow = 64;

// x[b, :] = emb_q[code[b], :] * emb_s[code[b]]
__global__ void embed_kernel(const int* __restrict__ code, const int8_t* __restrict__ emb,
                             const float* __restrict__ emb_s, int D, float* __restrict__ x) {
  const int b = blockIdx.x;
  const int c = code[b];
  const float s = emb_s[c];
  for (int d = threadIdx.x; d < D; d += blockDim.x)
    x[(size_t)b * D + d] = (float)emb[(size_t)c * D + d] * s;
}

// One block per stream: penalty, exact pairwise top-p, temperature, Gumbel
// argmax over the Vr residual-book logits at codebook position cb.
__global__ void __launch_bounds__(kFastSampThreads)
fast_sample_kernel(const float* __restrict__ head, const int* __restrict__ prev,
                   const float* __restrict__ gumbel, const float* __restrict__ temp,
                   const float* __restrict__ top_p, const float* __restrict__ rep,
                   float* __restrict__ logits_out, int* __restrict__ codes,
                   int* __restrict__ code_buf, int K, int Vr, int W, int cb) {
  const int b = blockIdx.x, tid = threadIdx.x;
  const int R = K - 1;
  extern __shared__ __align__(16) float sm[];
  float* lv = sm;       // penalized logits
  float* pv = sm + Vr;  // softmax probabilities
  __shared__ float scratch[33];
  __shared__ int win[kMaxWindow];
  __shared__ float red_v[32];
  __shared__ int red_i[32];

  for (int w = tid; w < W; w += blockDim.x) win[w] = prev[((size_t)b * R + cb - 1) * W + w];
  __syncthreads();
  const float r_pen = rep[b];
  float lmax = -FLT_MAX;
  for (int i = tid; i < Vr; i += blockDim.x) {
    float l = head[(size_t)b * Vr + i];
    bool hit = false;
    for (int w = 0; w < W; ++w) hit |= (win[w] == i);
    if (hit) l = l < 0.f ? l * r_pen : l / r_pen;
    lv[i] = l;
    logits_out[((size_t)b * R + cb - 1) * Vr + i] = l;
    lmax = fmaxf(lmax, l);
  }
  const float amax = block_reduce<true>(lmax, scratch);
  float se = 0.f;
  for (int i = tid; i < Vr; i += blockDim.x) se += expf(lv[i] - amax);
  const float z = logf(block_reduce<false>(se, scratch)) + amax;
  for (int i = tid; i < Vr; i += blockDim.x) pv[i] = expf(lv[i] - z);
  __syncthreads();

  const float tp = top_p[b];
  const float t_clamped = fmaxf(temp[b], 1e-5f);
  const float* g = gumbel + ((size_t)b * R + cb - 1) * Vr;
  float best = -FLT_MAX;
  int best_i = 0x7fffffff;
  for (int i = tid; i < Vr; i += blockDim.x) {
    const float li = lv[i];
    float above = 0.f;
    for (int j = 0; j < Vr; ++j) above += lv[j] > li ? pv[j] : 0.f;
    const bool keep = (above + pv[i] <= tp) || (li >= amax) || (tp >= 1.0f);
    const float val = (keep ? li : kNeg) / t_clamped + g[i];
    if (val > best) { best = val; best_i = i; }
  }
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
    for (int w = 1; w < (int)(blockDim.x / 32); ++w) {
      if (red_v[w] > best || (red_v[w] == best && red_i[w] < best_i)) {
        best = red_v[w];
        best_i = red_i[w];
      }
    }
    codes[b * R + cb - 1] = best_i;
    code_buf[b] = best_i;
  }
}

}  // namespace
}  // namespace fts

// ptrs/dims in the order of the enums above; returns a cudaError_t.
extern "C" int fts_fast_decode_frame(void* const* p, const int* d, float eps, void* stream) {
  using namespace fts;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dims dm{d[kB], d[kD], d[kHeads], d[kHkv], d[kDh], d[kI], eps};
  const int K = d[kK], L = d[kL], Vr = d[kVr], W = d[kW];
  if (dm.Dh > kMaxHeadDim || dm.Dh % 2 != 0 || dm.H / dm.Hkv > kMaxGroup ||
      dm.B > kMaxBatch || W > kMaxWindow)
    return (int)cudaErrorInvalidValue;
  const long long c_sh = (long long)K * dm.Dh, c_sb = c_sh * dm.Hkv;  // (L, B, Hkv, K, Dh)
  float* x = static_cast<float*>(p[kXBuf]);
  int* code = static_cast<int*>(p[kCodeBuf]);
  cudaError_t e;
  if ((e = cudaMemcpyAsync(x, p[kH], sizeof(float) * dm.B * dm.D, cudaMemcpyDeviceToDevice,
                           st)) != cudaSuccess)
    return (int)e;
  if ((e = cudaMemcpyAsync(code, p[kA0], sizeof(int) * dm.B, cudaMemcpyDeviceToDevice, st)) !=
      cudaSuccess)
    return (int)e;
  const size_t samp_smem = 2 * (size_t)Vr * sizeof(float);
  if (samp_smem > 48 * 1024) {
    e = cudaFuncSetAttribute(fast_sample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)samp_smem);
    if (e != cudaSuccess) return (int)e;
  }
  for (int pos = 0; pos < K; ++pos) {
    if (pos > 0) {
      embed_kernel<<<dm.B, 256, 0, st>>>(code, static_cast<const int8_t*>(p[kEmb]),
                                         static_cast<const float*>(p[kEmbS]), dm.D, x);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
    for (int l = 0; l < L; ++l) {
      const LayerPtrs lp = layer_at(p, kAttnNorm, dm, l);
      float* kc = static_cast<float*>(p[kKCache]) + (size_t)l * dm.B * c_sb;
      float* vc = static_cast<float*>(p[kVCache]) + (size_t)l * dm.B * c_sb;
      // the token's key/value land in its own cache row, read by later positions
      e = run_block<float>(lp, dm, x, static_cast<float*>(p[kQkvBuf]),
                           static_cast<float*>(p[kOBuf]), static_cast<float*>(p[kHBuf]),
                           nullptr, pos, static_cast<const __nv_bfloat16*>(p[kRope]), kc, vc,
                           c_sb, c_sh, K, kc + (size_t)pos * dm.Dh, vc + (size_t)pos * dm.Dh,
                           c_sb, c_sh, st);
      if (e != cudaSuccess) return (int)e;
    }
    if (pos == 0) continue;  // position 0's output is discarded
    float* head = static_cast<float*>(p[kHeadBuf]);
    e = launch_qgemv<kStore>(x, dm.B, dm.D, static_cast<const float*>(p[kFastNorm]), eps,
                             static_cast<const int8_t*>(p[kHead]),
                             static_cast<const float*>(p[kHeadS]), nullptr, nullptr, Vr, head,
                             st);
    if (e != cudaSuccess) return (int)e;
    fast_sample_kernel<<<dm.B, kFastSampThreads, samp_smem, st>>>(
        head, static_cast<const int*>(p[kPrev]), static_cast<const float*>(p[kGumbel]),
        static_cast<const float*>(p[kTemp]), static_cast<const float*>(p[kTopP]),
        static_cast<const float*>(p[kRep]), static_cast<float*>(p[kLogitsOut]),
        static_cast<int*>(p[kCodes]), code, K, Vr, W, pos);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}
