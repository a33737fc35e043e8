// Slow-stack decode step: the one-token forward of the slow transformer for
// B <= 16 streams, then the final norm and the tied int8 LM head, as one
// persistent cooperative kernel launch per call.
//
// Replaces the Pallas kernel fish_tts_tpu/ops/slow_stack.py::slow_stack_step
// (body :72-280, pallas_call :520).  Per layer: RMSNorm -> int8 W_qkv ->
// RoPE at each stream's position -> GQA attention over cache rows
// [0, min(pos, read_len)) plus the token's own key (joint softmax) -> int8
// W_o + residual -> RMSNorm -> int8 W_1/W_3 SwiGLU -> int8 W_2 + residual;
// then the final RMSNorm and the tied head over all V rows.  The cache is
// read-only: the token's roped key and value come back in new_k/new_v for
// the caller to write at pos.
//
// Bound: bytes.  At S1-mini width one step reads 440 MB of int8 layer
// weights and 160 MB of head, plus 57 KB per cache row (28 layers x 8 KV
// heads x 64 dims x K and V in bf16): about 0.18 ms at 3.35 TB/s for a
// 256-row cache.  Read in phases, the layers are also a chain of ~140
// dependent steps, so how soon one step follows another counts as much as
// the bytes.
//
// Design: one launch of every block the card can hold (cooperative launch;
// it fails rather than runs if the blocks cannot all be resident), with
// grid-wide barriers between the phases of each layer:
//   1. RMSNorm + W_qkv into a global qkv buffer
//   2. attention, split over the grid: a task is (stream, KV head, chunk
//      of kChunk cache rows); it ropes its G queries, reads its rows with
//      16-byte loads and writes the (max, denominator, weighted sum) of its
//      rows' softmax; chunk 0's task writes new_k/new_v.  The last task of
//      a (stream, KV head) to finish, found with an int counter, merges its
//      partials with the token's own key in chunk order
//   3. W_o + residual
//   4. RMSNorm + W_1/W_3 SwiGLU
//   5. W_2 + residual
// and after the last layer
//   6. final RMSNorm + the head, its rows streamed with 16-byte loads.
// A model with an untied head runs the variant without phase 6 (the head
// pointers null, V = 0), the JAX kernel's `with_head = False`
// (fish_tts_tpu/ops/slow_stack.py:405, :544-546): the 28 layers and the new
// K/V rows only, and the hidden state for the caller's own head.  It also
// drops the barrier after the last layer, which only the head phase needs.
// Block i owns the same output rows of every matrix at every layer
// (persistent.cuh).  The copy engine brings the rows, scales and norm
// weight of the block's weighted phases into a ring of one or two
// shared-memory slots, a phase or more ahead.  A copy starts inside a phase
// once that phase's own reads have landed, not just before a barrier (copy
// traffic there slows the barrier's release); the attention phase, which
// reads no weights, starts the copy of the largest matrices, W_1 and W_3.
// During phase 1 the block's cache chunks of the layer are prefetched into
// L2.  The chunk length is a constant, so a stream's result does not depend
// on the card or on B.  No float atomics: every sum is taken in one fixed
// order, so two calls give bit-identical results.  Cross-block data
// (residual, qkv, partials, SwiGLU hidden, attention output) is read with
// ld.global.cg, from L2.
#include <cooperative_groups.h>

#include "persistent.cuh"

enum {
  kX, kPos, kRope, kKCache, kVCache, kNewK, kNewV,
  kAttnNorm, kFfnNorm, kWqkv, kWqkvS, kWo, kWoS, kW1, kW1S, kW3, kW3S, kW2, kW2S,
  kFinalNorm, kHead, kHeadS, kHidden, kLogits, kScratch, kClock, kSkip, kNumPtrs
};
enum {
  kB, kL, kD, kH, kHkv, kDh, kI, kV, kS, kReadLen, kKvBf16, kClockCap, kScratchFloats,
  kNumDims
};

namespace fts {
namespace {

namespace cg = cooperative_groups;

constexpr int kChunk = 64;  // cache rows per attention task

// The weighted phases of a layer, in order; weighted phase n is kind n % 4
// of layer n / 4.
enum WKind { kQkvW = 0, kWoW = 1, kW13W = 2, kW2W = 3 };

struct SlowArgs {
  const float* x_in;  // (B, D) the embedded tokens
  const int* pos;
  const __nv_bfloat16* rope;
  const void* kc;     // (L, B, Hkv, S, Dh) bf16 or f32, read-only
  const void* vc;
  float* new_k;       // (L, B, Hkv, Dh)
  float* new_v;
  const float* attn_norm;
  const float* ffn_norm;
  const int8_t* wqkv; const float* wqkv_s;
  const int8_t* wo; const float* wo_s;
  const int8_t* w1; const float* w1_s;
  const int8_t* w3; const float* w3_s;
  const int8_t* w2; const float* w2_s;
  const float* final_norm;
  const int8_t* head; const float* head_s;  // null (and V = 0): no head phase
  float* hidden;      // (B, D) the residual stream, the final hidden state
  float* logits;      // (B, V), or null without a head
  float* qkv;         // (B, H*Dh + 2*Hkv*Dh)
  float* hbuf;        // (B, I) SwiGLU hidden
  float* obuf;        // (B, H*Dh) attention output
  float* pm;          // (B, Hkv, n_chunks, G) partial maxima
  float* pden;        // partial denominators
  float* pacc;        // (B, Hkv, n_chunks, G, Dh) partial weighted sums
  int* done_tasks;    // (L, B, Hkv) attention tasks finished, zeroed at the start
  unsigned long long* clock;  // (grid, clock_cap) barrier times, or nullptr
  const unsigned char* skip;  // the frame's skip flag, or nullptr
  int B, L, D, H, Hkv, Dh, I, V, S, read_len, n_chunks, clock_cap;
  int wslots;        // weight slots in shared memory: 1 or 2
  int wslot_bytes;   // bytes of one slot
  int wslot_offset;  // byte offset of the first slot
  float eps;
};

// Dynamic shared memory, in order:
//   act    the bf16 staging of a GEMV's input (B x its K), or that of a
//          normed input (B x D) with the f32 input itself at xf_offset
//   part   the GEMV's partial sums
//   slots  one or two weight slots (the launch sizes them)
__host__ __device__ inline size_t xf_offset(int B, int D) {
  return round16((size_t)B * D * sizeof(__nv_bfloat16));
}
__host__ __device__ inline size_t act_bytes(int B, int D, int max_k) {
  const size_t a = (size_t)B * max_k * sizeof(__nv_bfloat16);
  const size_t n = xf_offset(B, D) + (size_t)B * D * sizeof(float);
  return round16(a > n ? a : n);
}

// Attention tasks of a stream with `rows` live cache rows: one per chunk,
// and one (which only writes the token's key and value) when it has none.
__device__ __forceinline__ int chunks_of(int rows) {
  return rows > kChunk ? (rows + kChunk - 1) / kChunk : 1;
}

// (b, j, c) of attention task t, tasks ordered by stream, KV head, chunk;
// false past the last task.
__device__ __forceinline__ bool task_at(int t, const int* nrows, int B, int Hkv, int& b, int& j,
                                        int& c) {
  for (b = 0; b < B; ++b) {
    const int nc = chunks_of(nrows[b]);
    if (t < Hkv * nc) {
      j = t / nc;
      c = t - j * nc;
      return true;
    }
    t -= Hkv * nc;
  }
  return false;
}

// own[2 * kind], own[2 * kind + 1]: the rows this block owns in each kind.
__device__ Span phase_span(const SlowArgs& a, int n, const int* own) {
  const int kind = n % 4, l = n / 4;
  const int q_size = a.H * a.Dh, nqkv = q_size + 2 * a.Hkv * a.Dh;
  Span sp{nullptr, nullptr, nullptr, nullptr, nullptr, 0, 0, 0, 0};
  if (kind == kQkvW) {
    sp.w = a.wqkv + (size_t)l * nqkv * a.D; sp.s = a.wqkv_s + (size_t)l * nqkv;
    sp.norm = a.attn_norm + (size_t)l * a.D;
    sp.N = nqkv; sp.K = a.D;
  } else if (kind == kWoW) {
    sp.w = a.wo + (size_t)l * a.D * q_size; sp.s = a.wo_s + (size_t)l * a.D;
    sp.N = a.D; sp.K = q_size;
  } else if (kind == kW13W) {
    sp.w = a.w1 + (size_t)l * a.I * a.D; sp.s = a.w1_s + (size_t)l * a.I;
    sp.wu = a.w3 + (size_t)l * a.I * a.D; sp.su = a.w3_s + (size_t)l * a.I;
    sp.norm = a.ffn_norm + (size_t)l * a.D;
    sp.N = a.I; sp.K = a.D;
  } else {
    sp.w = a.w2 + (size_t)l * a.D * a.I; sp.s = a.w2_s + (size_t)l * a.D;
    sp.N = a.D; sp.K = a.I;
  }
  sp.r0 = own[2 * kind];
  sp.r1 = own[2 * kind + 1];
  return sp;
}

// xf = src (B, D) f32, then xs = bf16(xf * rstd_b * nw) with rstd_b the
// RMSNorm scale of row b.  The input is read once, by all threads at once.
__device__ void stage_rms(const float* src, int B, int D, const float* nw, float eps,
                          __nv_bfloat16* xs, float* xf, float* red, float* rstd) {
  for (int i = threadIdx.x; i < B * D / 4; i += kThreads)
    reinterpret_cast<float4*>(xf)[i] = __ldcg(reinterpret_cast<const float4*>(src) + i);
  __syncthreads();
  rms_scales(xf, B, D, eps, red, rstd);
  for (int i = threadIdx.x; i < B * D; i += kThreads) {
    const int b = i / D;
    xs[i] = __float2bfloat16_rn((xf[i] * rstd[b]) * nw[i - b * D]);
  }
  __syncthreads();
}

// xs = bf16(src) for src (B, n) f32 written by other blocks.
__device__ void stage_bf16(const float* src, int count, __nv_bfloat16* xs) {
  for (int i = threadIdx.x; i < count / 4; i += kThreads) {
    const float4 v = __ldcg(reinterpret_cast<const float4*>(src) + i);
    reinterpret_cast<__nv_bfloat162*>(xs)[2 * i] = __floats2bfloat162_rn(v.x, v.y);
    reinterpret_cast<__nv_bfloat162*>(xs)[2 * i + 1] = __floats2bfloat162_rn(v.z, v.w);
  }
  __syncthreads();
}

// The 16 bytes of a cache row at one lane as floats, exactly: 8 bf16 or 4 f32.
template <typename T>
__device__ __forceinline__ void row_floats(const uint4& u, float* f);
template <>
__device__ __forceinline__ void row_floats<__nv_bfloat16>(const uint4& u, float* f) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
template <>
__device__ __forceinline__ void row_floats<float>(const uint4& u, float* f) {
  f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
}

// Cache rows [c * kChunk, c * kChunk + nr) of stream b, KV head j, layer l.
template <typename T>
__device__ __forceinline__ size_t cache_at(const SlowArgs& a, int l, int b, int j, int c) {
  return (((size_t)l * a.B + b) * a.Hkv + j) * a.S * a.Dh + (size_t)c * kChunk * a.Dh;
}

// Thread 0 asks L2 for the cache rows of the attention tasks this block
// will run at layer l.
template <typename T>
__device__ void prefetch_chunks(const SlowArgs& a, int l, const int* nrows) {
  if (threadIdx.x != 0) return;
  int b, j, c;
  for (int t = blockIdx.x; task_at(t, nrows, a.B, a.Hkv, b, j, c); t += gridDim.x) {
    const int nr = min(kChunk, nrows[b] - c * kChunk);
    if (nr <= 0) continue;
    const unsigned bytes = (unsigned)(nr * a.Dh * sizeof(T));
    const size_t at = cache_at<T>(a, l, b, j, c);
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(
                     static_cast<const T*>(a.kc) + at), "r"(bytes) : "memory");
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(
                     static_cast<const T*>(a.vc) + at), "r"(bytes) : "memory");
  }
}

// Query head g of stream b, KV head j: the partials of (b, j) merged in
// chunk order with the token's own key, into obuf (B, H*Dh).  q is the
// roped query, k the roped key and v the value of the token (Dh floats
// each, in shared memory).  One warp; lane i holds dim pairs i and i + 32.
__device__ void combine_head(const SlowArgs& a, int b, int j, int g, const int* nrows,
                             const float* q, const float* k, const float* v_self) {
  const int lane = threadIdx.x & 31;
  const int G = a.H / a.Hkv, Dh = a.Dh, half = Dh / 2, hq = j * G + g;
  const int q_size = a.H * Dh;
  float2 v[2];
  float s = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int pi = lane + 32 * h;
    v[h] = make_float2(0.f, 0.f);
    if (pi < half) {
      v[h] = reinterpret_cast<const float2*>(v_self)[pi];
      const float2 qq = reinterpret_cast<const float2*>(q)[pi];
      const float2 kk = reinterpret_cast<const float2*>(k)[pi];
      s = fmaf(qq.y, kk.y, fmaf(qq.x, kk.x, s));
    }
  }
  const float s_self = warp_sum(s) * (1.0f / sqrtf((float)Dh));
  const int nc = chunks_of(nrows[b]);
  const size_t rec = (size_t)(b * a.Hkv + j) * a.n_chunks * G + g;  // + c * G
  float mx = s_self;
  for (int c = lane; c < nc; c += 32) mx = fmaxf(mx, __ldcg(a.pm + rec + (size_t)c * G));
  mx = warp_max(mx);
  const float p_self = expf(s_self - mx);
  float den = p_self;
  float2 acc[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) acc[h] = make_float2(p_self * v[h].x, p_self * v[h].y);
#pragma unroll 4
  for (int c = 0; c < nc; ++c) {
    const size_t r = rec + (size_t)c * G;
    const float w = expf(__ldcg(a.pm + r) - mx);
    den = fmaf(__ldcg(a.pden + r), w, den);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int pi = lane + 32 * h;
      if (pi < half) {
        const float2 pa = __ldcg(reinterpret_cast<const float2*>(a.pacc + r * Dh) + pi);
        acc[h].x = fmaf(pa.x, w, acc[h].x);
        acc[h].y = fmaf(pa.y, w, acc[h].y);
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int pi = lane + 32 * h;
    if (pi < half) {
      const size_t o = (size_t)b * q_size + hq * Dh + 2 * pi;
      __stcg(reinterpret_cast<float2*>(a.obuf + o), make_float2(acc[h].x / den, acc[h].y / den));
    }
  }
}

// Shared memory of the attention phase.
struct AttnSmem {
  float q[kMaxGroup * kMaxHeadDim];  // the task's roped queries
  float k[kMaxHeadDim];              // the token's roped key and its value
  float v[kMaxHeadDim];
  float sc[kChunk * kMaxGroup];      // scores [row][g]
  float st[2 * kMaxGroup];           // per query head: max, denominator
  float acc[kWarps * kMaxHeadDim];   // per warp: one head's weighted sum
  int last;                          // this block finished the task's (b, j) last
};

// Phase 2: the attention tasks t = blockIdx.x, + gridDim.x, ...  A task's
// threads split its rows: lpr lanes (Dh / (16 / sizeof(T))) hold one row,
// 16 bytes each; rows beyond kThreads / lpr take further passes.  Scores
// go to shared memory; warp g takes head g's max and denominator; each
// thread weights its rows' values, and the sums fold over the lanes of a
// warp and then over the warps in a fixed order.  The block that finishes
// the last task of a (b, j) merges it: its warp g takes query head g.
// after_loads() runs once the first task's rows have landed (or at once if
// there is no task).
template <typename T, typename F>
__device__ void attention(const SlowArgs& a, int l, const int* nrows,
                                   const __nv_bfloat16* rope_s, AttnSmem& sm, F after_loads) {
  constexpr int E = 16 / sizeof(T);                                // dims per lane
  constexpr int P = (kMaxHeadDim / E) * kChunk / kThreads > 0
                        ? (kMaxHeadDim / E) * kChunk / kThreads : 1;  // most passes
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = a.H / a.Hkv, Dh = a.Dh, half = Dh / 2;
  const int q_size = a.H * Dh, kv_size = a.Hkv * Dh, nqkv = q_size + 2 * kv_size;
  const int lpr = Dh / E, rpp = kThreads / lpr;
  const int sub = tid / lpr, part = tid - sub * lpr;
  const float scale = 1.0f / sqrtf((float)Dh);
  bool first = true;
  int b, j, c;
  for (int t = blockIdx.x; task_at(t, nrows, a.B, a.Hkv, b, j, c); t += gridDim.x) {
    const int nr = min(kChunk, nrows[b] - c * kChunk);  // <= 0: no live rows
    const size_t at = cache_at<T>(a, l, b, j, c);
    const uint4* kb = reinterpret_cast<const uint4*>(static_cast<const T*>(a.kc) + at);
    const uint4* vb = reinterpret_cast<const uint4*>(static_cast<const T*>(a.vc) + at);
    uint4 kr[P], vr[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int r = p * rpp + sub;
      kr[p] = vr[p] = make_uint4(0u, 0u, 0u, 0u);
      if (r < nr) {
        kr[p] = __ldg(kb + (size_t)r * lpr + part);
        vr[p] = __ldg(vb + (size_t)r * lpr + part);
      }
    }
    const float* row = a.qkv + (size_t)b * nqkv;
    const __nv_bfloat16* rr = rope_s + b * Dh;
    for (int i = tid; i < G * half; i += kThreads) {
      const int g = i / half, pi = i - g * half;
      const float2 v = __ldcg(reinterpret_cast<const float2*>(row + (j * G + g) * Dh) + pi);
      rope_pair(v.x, v.y, rr, pi, &sm.q[g * Dh + 2 * pi], &sm.q[g * Dh + 2 * pi + 1]);
    }
    for (int pi = tid; pi < half; pi += kThreads) {  // for the merge; chunk 0 returns them
      const float2 k = __ldcg(reinterpret_cast<const float2*>(row + q_size + j * Dh) + pi);
      const float2 v =
          __ldcg(reinterpret_cast<const float2*>(row + q_size + kv_size + j * Dh) + pi);
      float k0, k1;
      rope_pair(k.x, k.y, rr, pi, &k0, &k1);
      reinterpret_cast<float2*>(sm.k)[pi] = make_float2(k0, k1);
      reinterpret_cast<float2*>(sm.v)[pi] = v;
      if (c == 0) {
        const size_t o = (((size_t)l * a.B + b) * a.Hkv + j) * Dh;
        reinterpret_cast<float2*>(a.new_k + o)[pi] = make_float2(k0, k1);
        reinterpret_cast<float2*>(a.new_v + o)[pi] = v;
      }
    }
    __syncthreads();
    if (first) {
      // the rows are in use below; wait for them before the copy engine starts
      float dep = 0.f;
#pragma unroll
      for (int p = 0; p < P; ++p) dep += __uint_as_float(kr[p].x) + __uint_as_float(vr[p].x);
      asm volatile("add.f32 %0, %0, 0f00000000;" : "+f"(dep));
      after_loads();
      first = false;
    }
    // scores: the lpr lanes of a row fold their partial dot products
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int r = p * rpp + sub;
        if (p * rpp >= kChunk) break;
        float kf[E];
        row_floats<T>(kr[p], kf);
        const float* q = sm.q + g * Dh + part * E;
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) s = fmaf(q[e], kf[e], s);
        for (int o = lpr / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (part == 0 && r < nr) sm.sc[r * G + g] = s * scale;
      }
    }
    __syncthreads();
    if (warp < G) {
      const int g = warp;
      float m = kNeg;
      for (int r = lane; r < nr; r += 32) m = fmaxf(m, sm.sc[r * G + g]);
      m = warp_max(m);
      float d = 0.f;
      for (int r = lane; r < nr; r += 32) d += expf(sm.sc[r * G + g] - m);
      d = warp_sum(d);
      if (lane == 0) {
        sm.st[g] = m;
        sm.st[kMaxGroup + g] = d;
      }
    }
    __syncthreads();
    const size_t rec = ((size_t)(b * a.Hkv + j) * a.n_chunks + c) * G;
    for (int g = 0; g < G; ++g) {
      float acc[E];
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = 0.f;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int r = p * rpp + sub;
        if (p * rpp >= kChunk) break;
        if (r < nr) {
          const float w = expf(sm.sc[r * G + g] - sm.st[g]);
          float vf[E];
          row_floats<T>(vr[p], vf);
#pragma unroll
          for (int e = 0; e < E; ++e) acc[e] = fmaf(w, vf[e], acc[e]);
        }
      }
#pragma unroll
      for (int e = 0; e < E; ++e)
        for (int o = 16; o >= lpr; o >>= 1) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
      if (lane < lpr) {
#pragma unroll
        for (int e = 0; e < E; ++e) sm.acc[warp * kMaxHeadDim + part * E + e] = acc[e];
      }
      __syncthreads();
      for (int d = tid; d < Dh; d += kThreads) {
        float s = 0.f;
        for (int w = 0; w < kWarps; ++w) s += sm.acc[w * kMaxHeadDim + d];
        __stcg(a.pacc + (rec + g) * Dh + d, s);
      }
      if (tid == 0) {
        __stcg(a.pm + rec + g, sm.st[g]);
        __stcg(a.pden + rec + g, sm.st[kMaxGroup + g]);
      }
      __syncthreads();
    }
    if (tid == 0) {
      __threadfence();  // the partials are visible before the count is
      const int n = atomicAdd(a.done_tasks + ((size_t)l * a.B + b) * a.Hkv + j, 1);
      sm.last = n == chunks_of(nrows[b]) - 1;
      __threadfence();
    }
    __syncthreads();
    if (sm.last) {
      if (warp < G) combine_head(a, b, j, warp, nrows, sm.q + warp * Dh, sm.k, sm.v);
      __syncthreads();  // the next task overwrites q, k and v
    }
  }
  if (first) after_loads();
}

// Phase 6: logits[b, r] = head_s[r] * sum_k xs[b, k] * head[r, k] over the
// rows this block owns.  A warp takes U rows at a time and loads all their
// 16-byte chunks (up to 64 a row, two per lane) before it uses any, so each
// SM keeps 16 warps x U KB in flight.
template <int MAXB>
__device__ void head_rows(const SlowArgs& a, const __nv_bfloat16* xs) {
  constexpr int U = MAXB >= 16 ? 2 : 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int K = a.D, nch = K / 16, B = a.B;
  int r0, r1;
  owned(a.V, r0, r1);
  const int4 zero = make_int4(0, 0, 0, 0);
  for (int base = r0 + warp * U; base < r1; base += kWarps * U) {
    float acc[U][MAXB];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int b = 0; b < MAXB; ++b) acc[u][b] = 0.f;
    for (int c0 = 0; c0 < nch; c0 += 64) {
      int4 w[U][2];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = c0 + lane + 32 * h;
          w[u][h] = base + u < r1 && c < nch
                        ? __ldcs(reinterpret_cast<const int4*>(a.head + (size_t)(base + u) * K) + c)
                        : zero;
        }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = c0 + lane + 32 * h;
          if (c < nch) fma_chunk<MAXB, false>(w[u][h], zero, xs + c * 16, K, B, acc[u], acc[u]);
        }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = base + u;
      const float sc = r < r1 ? __ldg(a.head_s + r) : 0.f;
#pragma unroll
      for (int b = 0; b < MAXB; ++b) {
        if (b < B) {
          const float s = warp_sum(acc[u][b]);
          if (lane == 0 && r < r1) __stcs(a.logits + (size_t)b * a.V + r, s * sc);
        }
      }
    }
  }
}

template <int MAXB, typename T>
__global__ void __launch_bounds__(kThreads, 1) slow_step_kernel(const SlowArgs a) {
  // a skipped frame: every block reads the same flag before any barrier and
  // returns, so the grid leaves together and writes nothing
  if (a.skip != nullptr && *a.skip) return;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float rstd[kMaxBatch];
  __shared__ float red[kMaxBatch * kWarps];
  __shared__ __nv_bfloat16 rope_s[kMaxBatch * kMaxHeadDim];  // each stream's RoPE row
  __shared__ int nrows[kMaxBatch];                            // live cache rows
  __shared__ __align__(8) unsigned long long bars[2];         // one per weight slot
  __shared__ int own[8];                                      // owned rows of each kind
  __shared__ AttnSmem attn;

  const int B = a.B, D = a.D, I = a.I, L = a.L, Dh = a.Dh;
  const int q_size = a.H * Dh, nqkv = q_size + 2 * a.Hkv * Dh;
  const int max_k = D > q_size ? (D > I ? D : I) : (q_size > I ? q_size : I);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  float* xf = reinterpret_cast<float*>(smem + xf_offset(B, D));
  float* part = reinterpret_cast<float*>(smem + act_bytes(B, D, max_k));
  unsigned char* wsm = smem + a.wslot_offset;

  // The residual rows this block owns: thread i < (rows) * B holds row
  // xr0 + i / B of stream i % B (the launch checks that they fit).
  int xr0, xr1;
  owned(D, xr0, xr1);
  const bool x_owner = (int)threadIdx.x < (xr1 - xr0) * B;
  const int xj = threadIdx.x / B, xb = threadIdx.x - xj * B;
  float x_own = x_owner ? a.x_in[(size_t)xb * D + xr0 + xj] : 0.f;
  auto publish_x = [&]() {
    if (x_owner) __stcg(a.hidden + (size_t)xb * D + xr0 + xj, x_own);
  };

  // every barrier, with the block's arrival and departure times when the
  // caller asked for them
  int n_stamp = 0;
  auto barrier = [&]() {
    if (a.clock != nullptr) {
      __syncthreads();
      stamp(a.clock, a.clock_cap, n_stamp);
    }
    grid.sync();
    if (a.clock != nullptr) stamp(a.clock, a.clock_cap, n_stamp);
  };

  // The ring of weight slots: weighted phase n reads slot n % ns, whose
  // mbarrier completes once per copy (parity (n / ns) & 1).  A copy may
  // start once the phase ns before it has finished with the slot; pump()
  // starts every copy that may, at a phase's prefetch point and, with one
  // slot, at the end of a phase.
  const int ns = a.wslots, total = 4 * L;
  int issued = 0, done = 0;
  auto slot = [&](int n) { return wsm + (size_t)(n % ns) * a.wslot_bytes; };
  auto pump = [&]() {
    for (; issued < total && issued < done + ns; ++issued)
      issue_copy(phase_span(a, issued, own), slot(issued), &bars[issued % ns], D);
  };
  auto begin = [&](int n) {
    bar_wait(&bars[n % ns], (unsigned)(n / ns) & 1u);
    return phase_span(a, n, own);
  };
  auto finish = [&]() {
    __syncthreads();
    ++done;
    if (ns == 1) pump();
  };

  if (a.clock != nullptr) stamp(a.clock, a.clock_cap, n_stamp);
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(&bars[i])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (threadIdx.x < 4) {
    const int n[4] = {nqkv, D, I, D};  // in WKind order
    owned(n[threadIdx.x], own[2 * threadIdx.x], own[2 * threadIdx.x + 1]);
  }
  if (threadIdx.x < B) nrows[threadIdx.x] = min(a.pos[threadIdx.x], a.read_len);
  if (blockIdx.x == 0)  // used after the first barrier
    for (int i = threadIdx.x; i < L * B * a.Hkv; i += kThreads) a.done_tasks[i] = 0;
  for (int i = threadIdx.x; i < B * Dh; i += kThreads) {
    const int b = i / Dh;
    rope_s[i] = a.rope[(size_t)a.pos[b] * Dh + (i - b * Dh)];
  }
  __syncthreads();
  pump();

  for (int l = 0; l < L; ++l) {
    const int n = 4 * l;
    // phase 1: RMSNorm + W_qkv
    Span sp = begin(n);
    stage_rms(l == 0 ? a.x_in : a.hidden, B, D, slot_norm(sp, slot(n)), a.eps, xs, xf, red, rstd);
    pump();
    prefetch_chunks<T>(a, l, nrows);
    int S = gemv_partials<MAXB>(sp, slot(n), xs, B, part);
    store_rows<MAXB>(sp, slot(n), part, S, B, a.qkv, sp.N);
    finish();
    barrier();

    // phase 2: attention, merged
    attention<T>(a, l, nrows, rope_s, attn, pump);
    barrier();

    // phase 3: W_o + residual
    sp = begin(n + 1);
    stage_bf16(a.obuf, B * q_size, xs);
    pump();
    S = gemv_partials<MAXB>(sp, slot(n + 1), xs, B, part);
    if (x_owner) x_own += row_value<MAXB>(sp, slot(n + 1), part, S, xj, xb).x;
    publish_x();
    finish();
    barrier();

    // phase 4: RMSNorm + W_1/W_3 SwiGLU
    sp = begin(n + 2);
    stage_rms(a.hidden, B, D, slot_norm(sp, slot(n + 2)), a.eps, xs, xf, red, rstd);
    pump();
    S = gemv_partials<MAXB>(sp, slot(n + 2), xs, B, part);
    store_rows<MAXB>(sp, slot(n + 2), part, S, B, a.hbuf, I);
    finish();
    barrier();

    // phase 5: W_2 + residual
    sp = begin(n + 3);
    stage_bf16(a.hbuf, B * I, xs);
    pump();
    S = gemv_partials<MAXB>(sp, slot(n + 3), xs, B, part);
    if (x_owner) x_own += row_value<MAXB>(sp, slot(n + 3), part, S, xj, xb).x;
    publish_x();
    finish();
    // the head-less variant ends here: the kernel's end publishes the hidden
    if (l + 1 < L || a.head != nullptr || a.clock != nullptr) barrier();
  }

  // phase 6: final RMSNorm + the tied head
  if (a.head != nullptr) {
    stage_rms(a.hidden, B, D, a.final_norm, a.eps, xs, xf, red, rstd);
    head_rows<MAXB>(a, xs);
  }
  if (a.clock != nullptr) barrier();  // the clock's last stamp: the head's end
}

template <int MAXB, typename T>
cudaError_t launch_step(SlowArgs& sa, cudaStream_t st) {
  auto kern = slow_step_kernel<MAXB, T>;
  const int q_size = sa.H * sa.Dh, nqkv = q_size + 2 * sa.Hkv * sa.Dh;
  int max_k = sa.D > q_size ? sa.D : q_size;
  max_k = max_k > sa.I ? max_k : sa.I;
  const int sms = num_sms();
  // Shared memory is sized for one block per SM, the most rows per block:
  // a larger grid only owns fewer.
  auto rows = [&](int n) { return (size_t)(n + sms - 1) / sms; };
  if (rows(sa.D) * sa.B > (size_t)kThreads) return cudaErrorInvalidValue;
  size_t slot = rows(nqkv) * sa.D;
  const size_t phase_bytes[] = {rows(sa.D) * q_size, 2 * rows(sa.I) * sa.D, rows(sa.D) * sa.I};
  for (size_t b : phase_bytes) slot = slot > b ? slot : b;
  size_t max_rows = rows(nqkv);
  for (int n : {sa.D, sa.I}) max_rows = max_rows > rows(n) ? max_rows : rows(n);
  slot += 2 * round16(max_rows * sizeof(float) + 16) + sa.D * sizeof(float);  // scales, norm
  slot = round16(slot);
  // segment partial sums: at most max(rows per block, warps) tasks
  const size_t tasks = max_rows + kWarps;
  const size_t base = act_bytes(sa.B, sa.D, max_k) + round16(tasks * 2 * MAXB * sizeof(float));

  // the device's and the kernel's shared memory limits, and the occupancy
  // at the last size asked for, are looked up once
  static size_t avail = 0, last_smem = 0;
  static int per_sm = 0;
  cudaError_t e;
  if (avail == 0) {
    int dev = 0, optin = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
    if ((e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
        cudaSuccess)
      return e;
    cudaFuncAttributes attr;
    if ((e = cudaFuncGetAttributes(&attr, kern)) != cudaSuccess) return e;
    avail = (size_t)optin - attr.sharedSizeBytes;
  }
  sa.wslots = base + 2 * slot <= avail ? 2 : 1;
  if (base + slot > avail) return cudaErrorInvalidValue;
  sa.wslot_bytes = (int)slot;
  sa.wslot_offset = (int)base;
  const size_t smem = base + sa.wslots * slot;
  if (smem != last_smem) {
    if ((e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
      return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
    if (e != cudaSuccess) return e;
    last_smem = smem;
  }
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&sa};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern), dim3(per_sm * sms),
                                     dim3(kThreads), args, smem, st);
}

template <typename T>
cudaError_t launch(SlowArgs& sa, cudaStream_t st) {
  if (sa.B <= 1) return launch_step<1, T>(sa, st);
  if (sa.B <= 4) return launch_step<4, T>(sa, st);
  return launch_step<16, T>(sa, st);
}

}  // namespace
}  // namespace fts

// ptrs/dims in the order of the enums above; returns a cudaError_t.
extern "C" int fts_slow_stack_step(void* const* p, const int* d, float eps, void* stream) {
  using namespace fts;
  SlowArgs a;
  a.B = d[kB]; a.L = d[kL]; a.D = d[kD]; a.H = d[kH]; a.Hkv = d[kHkv]; a.Dh = d[kDh];
  a.I = d[kI]; a.V = d[kV]; a.S = d[kS]; a.read_len = d[kReadLen];
  a.clock_cap = d[kClockCap];
  a.eps = eps;
  const int kv_bf16 = d[kKvBf16];
  const int lpr = a.Dh * (kv_bf16 ? 2 : 4) / 16;  // lanes per 16-byte-loaded cache row
  if (a.B < 1 || a.B > kMaxBatch || a.L < 1 || a.Dh > kMaxHeadDim || a.Dh % 2 != 0 ||
      a.H % a.Hkv != 0 || a.H / a.Hkv > kMaxGroup || lpr < 1 || 32 % lpr != 0 ||
      lpr * 16 != a.Dh * (kv_bf16 ? 2 : 4) || a.D % 16 != 0 || a.I % 16 != 0 ||
      (a.H * a.Dh) % 16 != 0 || a.read_len < 1 || a.read_len > a.S || a.V < 0 ||
      (a.V == 0) != (p[kHead] == nullptr) || (a.V == 0) != (p[kLogits] == nullptr))
    return (int)cudaErrorInvalidValue;
  a.n_chunks = (a.read_len + kChunk - 1) / kChunk;
  a.x_in = static_cast<const float*>(p[kX]);
  a.pos = static_cast<const int*>(p[kPos]);
  a.rope = static_cast<const __nv_bfloat16*>(p[kRope]);
  a.kc = p[kKCache];
  a.vc = p[kVCache];
  a.new_k = static_cast<float*>(p[kNewK]);
  a.new_v = static_cast<float*>(p[kNewV]);
  a.attn_norm = static_cast<const float*>(p[kAttnNorm]);
  a.ffn_norm = static_cast<const float*>(p[kFfnNorm]);
  a.wqkv = static_cast<const int8_t*>(p[kWqkv]);
  a.wqkv_s = static_cast<const float*>(p[kWqkvS]);
  a.wo = static_cast<const int8_t*>(p[kWo]);
  a.wo_s = static_cast<const float*>(p[kWoS]);
  a.w1 = static_cast<const int8_t*>(p[kW1]);
  a.w1_s = static_cast<const float*>(p[kW1S]);
  a.w3 = static_cast<const int8_t*>(p[kW3]);
  a.w3_s = static_cast<const float*>(p[kW3S]);
  a.w2 = static_cast<const int8_t*>(p[kW2]);
  a.w2_s = static_cast<const float*>(p[kW2S]);
  a.final_norm = static_cast<const float*>(p[kFinalNorm]);
  a.head = static_cast<const int8_t*>(p[kHead]);
  a.head_s = static_cast<const float*>(p[kHeadS]);
  a.hidden = static_cast<float*>(p[kHidden]);
  a.logits = static_cast<float*>(p[kLogits]);
  // scratch, each part a multiple of 4 floats: qkv, the SwiGLU hidden, the
  // attention output, the attention partials (max, denominator, sums) and
  // the count of finished attention tasks
  const int G = a.H / a.Hkv;
  const long long recs = (long long)a.B * a.Hkv * a.n_chunks * G;
  const long long parts[] = {(long long)a.B * (a.H + 2 * a.Hkv) * a.Dh, (long long)a.B * a.I,
                             (long long)a.B * a.H * a.Dh, recs, recs, recs * a.Dh,
                             (long long)a.L * a.B * a.Hkv};
  float* at[7];
  long long used = 0;
  for (int i = 0; i < 7; ++i) {
    at[i] = static_cast<float*>(p[kScratch]) + used;
    used += (parts[i] + 3) / 4 * 4;
  }
  if (used > d[kScratchFloats]) return (int)cudaErrorInvalidValue;
  a.qkv = at[0];
  a.hbuf = at[1];
  a.obuf = at[2];
  a.pm = at[3];
  a.pden = at[4];
  a.pacc = at[5];
  a.done_tasks = reinterpret_cast<int*>(at[6]);
  a.clock = static_cast<unsigned long long*>(p[kClock]);
  a.skip = static_cast<const unsigned char*>(p[kSkip]);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_bf16) return (int)launch<__nv_bfloat16>(a, st);
  return (int)launch<float>(a, st);
}

extern "C" const char* fts_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
