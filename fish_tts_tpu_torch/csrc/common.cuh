// Device building blocks shared by the slow-stack and fast-decoder kernels.
//
// qgemv: y[b, n] = epilogue(sum_k bf16(x'[b, k]) * W[n, k] * s[n]) over B <= 16
//   streams, with x' the optional RMSNorm of x.  W is int8 in (out, in)
//   layout, so each output row is one contiguous run of K bytes and a lane
//   loads 16 of them at a time.  The activation is rounded to bf16 before the
//   product, as the Pallas kernels do (fish_tts_tpu/ops/slow_stack.py:140-144,
//   fast_decoder.py:223-227); bf16 x int8 products are exact in f32 and
//   accumulate in f32.  Bound: the weight bytes (one GEMV reads each weight
//   once); the activations sit in shared memory.
//
// decode_attn: one query token per stream against the cache rows below its
//   position plus its own key (the joint softmax of
//   ops/attention.gqa_attention_two_part), RoPE applied to q and k on load.
//   One block per (kv head, stream); its G query heads share every cache
//   row it loads, so each cache byte is read once.
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

// ---------------------------------------------------------------------------
// int8 GEMV
// ---------------------------------------------------------------------------

constexpr int kGemvThreads = 128;                  // 4 warps
constexpr int kGemvRowsPerWarp = 2;
constexpr int kGemvRows = 4 * kGemvRowsPerWarp;    // rows per block per pass

enum Epilogue { kStore = 0, kResidual = 1, kSwiGLU = 2 };

template <int MAXB, int EPI>
__global__ void __launch_bounds__(kGemvThreads)
qgemv_kernel(const float* __restrict__ x, int B, int K,
             const float* __restrict__ norm_w, float eps,
             const int8_t* __restrict__ w, const float* __restrict__ s,
             const int8_t* __restrict__ w_up, const float* __restrict__ s_up,
             int N, float* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [B][K]
  __shared__ float rstd[MAXB];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (norm_w != nullptr) {
    for (int b = warp; b < B; b += kGemvThreads / 32) {
      float ss = 0.f;
      for (int k = lane; k < K; k += 32) {
        const float v = x[b * K + k];
        ss += v * v;
      }
      ss = warp_sum(ss);
      if (lane == 0) rstd[b] = 1.0f / sqrtf(ss / (float)K + eps);
    }
    __syncthreads();
  }
  for (int i = tid; i < B * K; i += kGemvThreads) {
    const int b = i / K, k = i - b * K;
    float v = x[i];
    if (norm_w != nullptr) v = (v * rstd[b]) * norm_w[k];
    xs[i] = __float2bfloat16_rn(v);
  }
  __syncthreads();

  const int n_groups = (N + kGemvRows - 1) / kGemvRows;
  for (int g = blockIdx.x; g < n_groups; g += gridDim.x) {
    const int n0 = g * kGemvRows + warp * kGemvRowsPerWarp;
    float acc[kGemvRowsPerWarp][MAXB];
    float acc_up[kGemvRowsPerWarp][MAXB];
#pragma unroll
    for (int r = 0; r < kGemvRowsPerWarp; ++r)
#pragma unroll
      for (int b = 0; b < MAXB; ++b) acc[r][b] = acc_up[r][b] = 0.f;

    for (int k0 = lane * 16; k0 < K; k0 += 32 * 16) {
      int4 wv[kGemvRowsPerWarp], wu[kGemvRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kGemvRowsPerWarp; ++r) {
        const int n = n0 + r;
        const int4 zero = make_int4(0, 0, 0, 0);
        wv[r] = n < N ? __ldg(reinterpret_cast<const int4*>(w + (size_t)n * K + k0)) : zero;
        if (EPI == kSwiGLU)
          wu[r] = n < N ? __ldg(reinterpret_cast<const int4*>(w_up + (size_t)n * K + k0)) : zero;
      }
#pragma unroll
      for (int b = 0; b < MAXB; ++b) {
        if (b < B) {
          const uint4* xp = reinterpret_cast<const uint4*>(xs + b * K + k0);
          const uint4 xa = xp[0], xb = xp[1];
          const __nv_bfloat162* h2a = reinterpret_cast<const __nv_bfloat162*>(&xa);
          const __nv_bfloat162* h2b = reinterpret_cast<const __nv_bfloat162*>(&xb);
          float xf[16];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 fa = __bfloat1622float2(h2a[j]);
            const float2 fb = __bfloat1622float2(h2b[j]);
            xf[2 * j] = fa.x; xf[2 * j + 1] = fa.y;
            xf[8 + 2 * j] = fb.x; xf[8 + 2 * j + 1] = fb.y;
          }
#pragma unroll
          for (int r = 0; r < kGemvRowsPerWarp; ++r) {
            const int8_t* wb = reinterpret_cast<const int8_t*>(&wv[r]);
            float a = acc[r][b];
#pragma unroll
            for (int j = 0; j < 16; ++j) a = fmaf(xf[j], (float)wb[j], a);
            acc[r][b] = a;
            if (EPI == kSwiGLU) {
              const int8_t* ub = reinterpret_cast<const int8_t*>(&wu[r]);
              float u = acc_up[r][b];
#pragma unroll
              for (int j = 0; j < 16; ++j) u = fmaf(xf[j], (float)ub[j], u);
              acc_up[r][b] = u;
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kGemvRowsPerWarp; ++r) {
      const int n = n0 + r;
#pragma unroll
      for (int b = 0; b < MAXB; ++b) {
        if (b < B) {
          const float a = warp_sum(acc[r][b]);
          const float u = EPI == kSwiGLU ? warp_sum(acc_up[r][b]) : 0.f;
          if (lane == 0 && n < N) {
            const float v = a * s[n];
            float* out = y + (size_t)b * N + n;
            if (EPI == kStore) {
              *out = v;
            } else if (EPI == kResidual) {
              *out = *out + v;
            } else {
              *out = (v * sigmoidf(v)) * (u * s_up[n]);
            }
          }
        }
      }
    }
  }
}

inline int num_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

template <int MAXB, int EPI>
cudaError_t launch_qgemv_t(const float* x, int B, int K, const float* norm_w, float eps,
                           const int8_t* w, const float* s, const int8_t* w_up,
                           const float* s_up, int N, float* y, cudaStream_t st) {
  const size_t smem = (size_t)B * K * sizeof(__nv_bfloat16);
  static size_t smem_set = 48 * 1024;
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(qgemv_kernel<MAXB, EPI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  const int n_groups = (N + kGemvRows - 1) / kGemvRows;
  const int grid = n_groups < num_sms() * 16 ? n_groups : num_sms() * 16;
  qgemv_kernel<MAXB, EPI><<<grid, kGemvThreads, smem, st>>>(x, B, K, norm_w, eps, w, s,
                                                            w_up, s_up, N, y);
  return cudaGetLastError();
}

template <int EPI>
cudaError_t launch_qgemv(const float* x, int B, int K, const float* norm_w, float eps,
                         const int8_t* w, const float* s, const int8_t* w_up,
                         const float* s_up, int N, float* y, cudaStream_t st) {
  if (B <= 1) return launch_qgemv_t<1, EPI>(x, B, K, norm_w, eps, w, s, w_up, s_up, N, y, st);
  if (B <= 2) return launch_qgemv_t<2, EPI>(x, B, K, norm_w, eps, w, s, w_up, s_up, N, y, st);
  if (B <= 4) return launch_qgemv_t<4, EPI>(x, B, K, norm_w, eps, w, s, w_up, s_up, N, y, st);
  if (B <= 8) return launch_qgemv_t<8, EPI>(x, B, K, norm_w, eps, w, s, w_up, s_up, N, y, st);
  return launch_qgemv_t<16, EPI>(x, B, K, norm_w, eps, w, s, w_up, s_up, N, y, st);
}

// ---------------------------------------------------------------------------
// Decode attention
// ---------------------------------------------------------------------------

constexpr int kAttnThreads = 128;  // 4 warps
constexpr int kAttnWarps = kAttnThreads / 32;
constexpr int kMaxGroup = 8;       // query heads per kv head
constexpr int kMaxHeadDim = 128;
constexpr int kMaxDimPerLane = kMaxHeadDim / 32;

template <typename T>
__device__ __forceinline__ float load_f(const T* p) { return static_cast<float>(*p); }
template <>
__device__ __forceinline__ float load_f<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Interleaved-pair rotation with the bf16 (cos, sin) table applied in f32.
__device__ __forceinline__ void rope_pair(float x0, float x1, const __nv_bfloat16* rope_row,
                                          int i, float* o0, float* o1) {
  const float c = __bfloat162float(rope_row[2 * i]);
  const float sn = __bfloat162float(rope_row[2 * i + 1]);
  *o0 = __fadd_rn(__fmul_rn(x0, c), -__fmul_rn(x1, sn));
  *o1 = __fadd_rn(__fmul_rn(x1, c), __fmul_rn(x0, sn));
}

// qkv: (B, H*Dh + 2*Hkv*Dh) f32 projections before RoPE.
// pos: per-stream positions (pos_arr) or one position for all (pos_const).
// Cache rows r < min(pos, row_cap) of kc/vc (row stride Dh; stream and head
// strides in elements) are attended together with the token's own key.
// The roped key and the value are written to new_k/new_v (f32); o gets the
// (B, H*Dh) attention output, head hq = j*G + g.
template <typename T>
__global__ void __launch_bounds__(kAttnThreads)
decode_attn_kernel(const float* __restrict__ qkv, const int* __restrict__ pos_arr,
                   int pos_const, const __nv_bfloat16* __restrict__ rope,
                   const T* __restrict__ kc, const T* __restrict__ vc,
                   long long c_sb, long long c_sh, int row_cap,
                   float* __restrict__ new_k, float* __restrict__ new_v,
                   long long n_sb, long long n_sh, float* __restrict__ o,
                   int H, int Hkv, int Dh, float scale) {
  const int j = blockIdx.x, b = blockIdx.y;
  const int G = H / Hkv;
  const int q_size = H * Dh, kv_size = Hkv * Dh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pos = pos_arr != nullptr ? pos_arr[b] : pos_const;

  __shared__ float q_s[kMaxGroup][kMaxHeadDim];
  __shared__ float k_self[kMaxHeadDim], v_self[kMaxHeadDim];
  __shared__ float s_self[kMaxGroup];
  __shared__ float m_w[kAttnWarps][kMaxGroup], d_w[kAttnWarps][kMaxGroup];
  __shared__ float a_w[kAttnWarps][kMaxGroup][kMaxHeadDim];

  const float* row = qkv + (size_t)b * (q_size + 2 * kv_size);
  const __nv_bfloat16* rope_row = rope + (size_t)pos * Dh;
  const int half = Dh / 2;
  for (int t = tid; t < (G + 1) * half; t += kAttnThreads) {
    const int g = t / half, i = t - g * half;
    const float* src = g < G ? row + (j * G + g) * Dh : row + q_size + j * Dh;
    float o0, o1;
    rope_pair(src[2 * i], src[2 * i + 1], rope_row, i, &o0, &o1);
    if (g < G) {
      q_s[g][2 * i] = o0;
      q_s[g][2 * i + 1] = o1;
    } else {
      k_self[2 * i] = o0;
      k_self[2 * i + 1] = o1;
    }
  }
  for (int d = tid; d < Dh; d += kAttnThreads) v_self[d] = row[q_size + kv_size + j * Dh + d];
  __syncthreads();
  for (int d = tid; d < Dh; d += kAttnThreads) {
    new_k[b * n_sb + j * n_sh + d] = k_self[d];
    new_v[b * n_sb + j * n_sh + d] = v_self[d];
  }

  // cache rows: warp w takes rows w, w+4, ...; lane owns dims lane + 32*i
  float m[kMaxGroup], den[kMaxGroup], acc[kMaxGroup][kMaxDimPerLane];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    m[g] = kNeg;
    den[g] = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxDimPerLane; ++i) acc[g][i] = 0.f;
  }
  const int n_rows = pos < row_cap ? pos : row_cap;
  const T* kb = kc + b * c_sb + j * c_sh;
  const T* vb = vc + b * c_sb + j * c_sh;
  for (int r = warp; r < n_rows; r += kAttnWarps) {
    float kv[kMaxDimPerLane], vv[kMaxDimPerLane];
#pragma unroll
    for (int i = 0; i < kMaxDimPerLane; ++i) {
      const int d = lane + 32 * i;
      kv[i] = d < Dh ? load_f(kb + (size_t)r * Dh + d) : 0.f;
      vv[i] = d < Dh ? load_f(vb + (size_t)r * Dh + d) : 0.f;
    }
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g < G) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < kMaxDimPerLane; ++i) {
          const int d = lane + 32 * i;
          if (d < Dh) part = fmaf(q_s[g][d], kv[i], part);
        }
        const float sc = warp_sum(part) * scale;
        const float m_new = fmaxf(m[g], sc);
        const float alpha = expf(m[g] - m_new);
        const float p = expf(sc - m_new);
        den[g] = den[g] * alpha + p;
#pragma unroll
        for (int i = 0; i < kMaxDimPerLane; ++i) acc[g][i] = acc[g][i] * alpha + p * vv[i];
        m[g] = m_new;
      }
    }
  }
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g < G) {
      if (lane == 0) {
        m_w[warp][g] = m[g];
        d_w[warp][g] = den[g];
      }
#pragma unroll
      for (int i = 0; i < kMaxDimPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < Dh) a_w[warp][g][d] = acc[g][i];
      }
    }
  }
  // the token's own key: warp g scores query head g
  for (int g = warp; g < G; g += kAttnWarps) {
    float part = 0.f;
    for (int d = lane; d < Dh; d += 32) part = fmaf(q_s[g][d], k_self[d], part);
    part = warp_sum(part);
    if (lane == 0) s_self[g] = part * scale;
  }
  __syncthreads();
  for (int t = tid; t < G * Dh; t += kAttnThreads) {
    const int g = t / Dh, d = t - g * Dh;
    float mx = s_self[g];
    for (int w = 0; w < kAttnWarps; ++w) mx = fmaxf(mx, m_w[w][g]);
    const float ps = expf(s_self[g] - mx);
    float dn = ps, ac = ps * v_self[d];
    for (int w = 0; w < kAttnWarps; ++w) {
      const float al = expf(m_w[w][g] - mx);
      dn += d_w[w][g] * al;
      ac += a_w[w][g][d] * al;
    }
    o[(size_t)b * q_size + (j * G + g) * Dh + d] = ac / dn;
  }
}

// One transformer block for B streams on the residual stream x (B, D):
//   qkv = W_qkv rms(x);  o = attn(rope(q), cache ++ rope(k));  x += W_o o;
//   x += W_2 (silu(W_1 rms(x)) * W_3 rms(x)).
struct LayerPtrs {
  const float* attn_norm;
  const float* ffn_norm;
  const int8_t* wqkv; const float* wqkv_s;
  const int8_t* wo; const float* wo_s;
  const int8_t* w1; const float* w1_s;
  const int8_t* w3; const float* w3_s;
  const int8_t* w2; const float* w2_s;
};

struct Dims {
  int B, D, H, Hkv, Dh, I;
  float eps;
};

template <typename T>
cudaError_t run_block(const LayerPtrs& lp, const Dims& dm, float* x, float* qkv, float* o,
                      float* hbuf, const int* pos_arr, int pos_const,
                      const __nv_bfloat16* rope, const T* kc, const T* vc,
                      long long c_sb, long long c_sh, int row_cap, float* new_k,
                      float* new_v, long long n_sb, long long n_sh, cudaStream_t st) {
  const int q_size = dm.H * dm.Dh, kv_size = dm.Hkv * dm.Dh;
  cudaError_t e;
  e = launch_qgemv<kStore>(x, dm.B, dm.D, lp.attn_norm, dm.eps, lp.wqkv, lp.wqkv_s, nullptr,
                           nullptr, q_size + 2 * kv_size, qkv, st);
  if (e != cudaSuccess) return e;
  decode_attn_kernel<T><<<dim3(dm.Hkv, dm.B), kAttnThreads, 0, st>>>(
      qkv, pos_arr, pos_const, rope, kc, vc, c_sb, c_sh, row_cap, new_k, new_v, n_sb, n_sh,
      o, dm.H, dm.Hkv, dm.Dh, 1.0f / sqrtf((float)dm.Dh));
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  e = launch_qgemv<kResidual>(o, dm.B, q_size, nullptr, dm.eps, lp.wo, lp.wo_s, nullptr,
                              nullptr, dm.D, x, st);
  if (e != cudaSuccess) return e;
  e = launch_qgemv<kSwiGLU>(x, dm.B, dm.D, lp.ffn_norm, dm.eps, lp.w1, lp.w1_s, lp.w3,
                            lp.w3_s, dm.I, hbuf, st);
  if (e != cudaSuccess) return e;
  return launch_qgemv<kResidual>(hbuf, dm.B, dm.I, nullptr, dm.eps, lp.w2, lp.w2_s, nullptr,
                                 nullptr, dm.D, x, st);
}

// Pointers to layer l of stacked (L, ...) weights.
inline LayerPtrs layer_at(void* const* p, int first, const Dims& dm, int l) {
  const int q_size = dm.H * dm.Dh, kv_size = dm.Hkv * dm.Dh;
  const size_t nqkv = q_size + 2 * kv_size;
  LayerPtrs lp;
  lp.attn_norm = static_cast<const float*>(p[first + 0]) + (size_t)l * dm.D;
  lp.ffn_norm = static_cast<const float*>(p[first + 1]) + (size_t)l * dm.D;
  lp.wqkv = static_cast<const int8_t*>(p[first + 2]) + (size_t)l * nqkv * dm.D;
  lp.wqkv_s = static_cast<const float*>(p[first + 3]) + (size_t)l * nqkv;
  lp.wo = static_cast<const int8_t*>(p[first + 4]) + (size_t)l * dm.D * q_size;
  lp.wo_s = static_cast<const float*>(p[first + 5]) + (size_t)l * dm.D;
  lp.w1 = static_cast<const int8_t*>(p[first + 6]) + (size_t)l * dm.I * dm.D;
  lp.w1_s = static_cast<const float*>(p[first + 7]) + (size_t)l * dm.I;
  lp.w3 = static_cast<const int8_t*>(p[first + 8]) + (size_t)l * dm.I * dm.D;
  lp.w3_s = static_cast<const float*>(p[first + 9]) + (size_t)l * dm.I;
  lp.w2 = static_cast<const int8_t*>(p[first + 10]) + (size_t)l * dm.D * dm.I;
  lp.w2_s = static_cast<const float*>(p[first + 11]) + (size_t)l * dm.D;
  return lp;
}

}  // namespace
}  // namespace fts
