// Slow-stack decode step: the one-token forward of the slow transformer for
// B <= 16 streams, then the final norm and the tied int8 LM head.
//
// Replaces the Pallas kernel fish_tts_tpu/ops/slow_stack.py::slow_stack_step
// (body :72-280, head phase :257-267).  Per layer: RMSNorm -> int8 W_qkv ->
// RoPE at each stream's position -> GQA attention over cache rows
// [0, min(pos, read_len)) plus the token's own key (joint softmax) -> int8
// W_o + residual -> RMSNorm -> int8 W_1/W_3 SwiGLU -> int8 W_2 + residual.
// The cache is read-only: the token's roped key and value come back in
// new_k/new_v for the caller to write at pos.
//
// Bound: bytes.  At S1-mini width one step streams 440 MB of int8 layer
// weights, 160 MB of head and 57 KB per cache row.  Design: five launches
// per layer from one host loop (common.cuh: qgemv with the norm fused into
// its prologue and the residual / SwiGLU into its epilogue, and one
// decode-attention kernel), each GEMV reading its weights once with 16-byte
// loads of contiguous (out, in) int8 rows; the head is one more qgemv over
// the V rows of the embedding table.
#include "common.cuh"

enum {
  kX, kPos, kRope, kKCache, kVCache, kNewK, kNewV,
  kAttnNorm, kFfnNorm, kWqkv, kWqkvS, kWo, kWoS, kW1, kW1S, kW3, kW3S, kW2, kW2S,
  kFinalNorm, kHead, kHeadS, kLogits, kQkvBuf, kOBuf, kHBuf, kNumPtrs
};
enum { kB, kL, kD, kH, kHkv, kDh, kI, kV, kS, kReadLen, kKvBf16, kNumDims };

namespace {

template <typename T>
cudaError_t run(void* const* p, const int* d, float eps, cudaStream_t st) {
  using namespace fts;
  const Dims dm{d[kB], d[kD], d[kH], d[kHkv], d[kDh], d[kI], eps};
  const int L = d[kL], S = d[kS];
  const long long c_sh = (long long)S * dm.Dh, c_sb = c_sh * dm.Hkv;
  const long long n_sh = dm.Dh, n_sb = n_sh * dm.Hkv;
  float* x = static_cast<float*>(p[kX]);
  for (int l = 0; l < L; ++l) {
    const LayerPtrs lp = layer_at(p, kAttnNorm, dm, l);
    const T* kc = static_cast<const T*>(p[kKCache]) + (size_t)l * dm.B * c_sb;
    const T* vc = static_cast<const T*>(p[kVCache]) + (size_t)l * dm.B * c_sb;
    float* nk = static_cast<float*>(p[kNewK]) + (size_t)l * dm.B * n_sb;
    float* nv = static_cast<float*>(p[kNewV]) + (size_t)l * dm.B * n_sb;
    cudaError_t e = run_block<T>(
        lp, dm, x, static_cast<float*>(p[kQkvBuf]), static_cast<float*>(p[kOBuf]),
        static_cast<float*>(p[kHBuf]), static_cast<const int*>(p[kPos]), 0,
        static_cast<const __nv_bfloat16*>(p[kRope]), kc, vc, c_sb, c_sh, d[kReadLen], nk, nv,
        n_sb, n_sh, st);
    if (e != cudaSuccess) return e;
  }
  return launch_qgemv<kStore>(x, dm.B, dm.D, static_cast<const float*>(p[kFinalNorm]), eps,
                              static_cast<const int8_t*>(p[kHead]),
                              static_cast<const float*>(p[kHeadS]), nullptr, nullptr, d[kV],
                              static_cast<float*>(p[kLogits]), st);
}

}  // namespace

// ptrs/dims in the order of the enums above; x is updated in place to the
// final hidden state.  Returns a cudaError_t.
extern "C" int fts_slow_stack_step(void* const* ptrs, const int* dims, float eps,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dims[kDh] > fts::kMaxHeadDim || dims[kDh] % 2 != 0 ||
      dims[kH] / dims[kHkv] > fts::kMaxGroup || dims[kB] > fts::kMaxBatch)
    return (int)cudaErrorInvalidValue;
  if (dims[kKvBf16]) return (int)run<__nv_bfloat16>(ptrs, dims, eps, st);
  return (int)run<float>(ptrs, dims, eps, st);
}

extern "C" const char* fts_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
