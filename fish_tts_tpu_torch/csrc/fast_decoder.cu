// Fast-codebook decoder: the per-frame loop over the K codebook positions,
// as one persistent cooperative kernel launch per call.
//
// Replaces the Pallas kernel fish_tts_tpu/ops/fast_decoder.py
// ::_fast_decode_frame (body _make_kernel :116-428, fori_loop :423,
// pallas_call :686) in its "value" and "s8" dequant modes (DEQUANT_MODES
// :98, the "s8" branch :239-262), one instantiation each.  Position 0 runs the fast layers
// on the projected slow hidden state and only fills the per-frame K/V
// cache.  Each position cb = 1..K-1 embeds the previous code (int8 row x row
// scale), runs the layers with causal attention over the positions so far,
// applies fast_norm and the head over the first Vr rows of fast_output, then
// the repetition penalty over the stream's window row cb - 1, the exact
// sort-free top-p (i is kept iff sum(p_j : l_j > l_i) + p_i <= top_p, or i
// is the argmax, or top_p >= 1), temperature and the Gumbel argmax.
//
// "value": each GEMV input rounds to bf16, products accumulate in f32.
// "s8": each GEMV input row is quantized to int8 by its own absmax
// (sc = max(amax, 1e-30) / 127, xq = round_half_even(x / sc) with an IEEE
// quotient), after the barrier that ends the phase writing it, so every
// block gets the same row and scale; the products are s8 x s8 sums in s32
// on the int8 tensor cores (mma.sync m16n8k32), scaled as (sum * sc) *
// weight scale.  The embedding stays exact.  The s8 staging is half the
// bytes of the bf16 one; the bound is the same bytes, its operations at
// the int8 rate.  Beyond the bytes, what the "s8" variant adds to every
// phase is the absmax of each input row: a pass per row in every block
// (for the W_2 input, B x I f32 read from L2) before the quantizing pass,
// and a GEMV whose per-stream dot products reread the staging for every
// weight chunk.  So a row's absmax comes with the phase that computes it:
// the W_1/W_3 phase publishes each block's per-stream max of the SwiGLU
// rows it stores ((grid, B) floats in scratch), which the W_2 phase folds
// while its one read of the rows from L2 is in flight (cp.async into a
// ring in shared memory); the attention output's max is taken where each
// warp writes it.  Only the RMSNorm outputs keep an absmax pass of their
// own, over shared memory: their values exist only once the row's RMS is
// known, and the norm weight scales each lane after it, so no max of the
// residual rows gives theirs.  The quotient x / sc is taken as x times the
// reciprocal, with a tie near a half-integer decided exactly
// (persistent.cuh, s8_fast / s8_near).  A tensor-core tile takes every
// stream's 32 staged bytes at once (A, 16 x 32) against 8 weight rows (B),
// so the staging is read once per n8 tile, and the s32 sums live in the
// mma fragments, not in per-stream registers.
//
// Bound: bytes.  At S1-mini width the four int8 layers are 62.9 MB: read
// once that is 0.019 ms at 3.35 TB/s, but the stack does not fit the 50 MB
// L2 the way the Pallas kernel keeps it in VMEM, so streamed once per
// position it is 10 x 62.9 MB = 0.19 ms.  Each position is also a chain of
// ~18 dependent steps (four per layer, head, sampling), each ending in a
// grid-wide barrier, so the time is set as much by how soon one step can
// follow another as by the bytes.
//
// Design: one launch of every block the card can hold (cooperative launch;
// it fails rather than runs if the blocks cannot all be resident), the
// phases separated by grid-wide barriers (cooperative_groups grid sync):
//   1. (merge of the sampled code, embedding) + RMSNorm + W_qkv
//   2. RoPE + attention + W_o + residual, or in the batched "value"
//      instantiations (MAXB 4 and 16, so B >= 2) two phases:
//      2a. RoPE + attention, spread over the grid: each (stream, query
//          head) is one warp's unit, its bf16 output row goes to obuf
//      2b. W_o + residual on obuf, staged from L2
//   3. RMSNorm + W_1/W_3 SwiGLU
//   4. W_2 + residual                        (1-4 for each layer)
//   5. fast_norm + head over the first Vr rows
//   6. penalty + softmax + pairwise top-p + Gumbel score over a share of
//      the Vr lanes, one (value, index) candidate per block and stream
// Phase 2 in one piece repeats every stream's attention in every block, so
// at B = 16 each block would walk 128 (stream, KV head) tasks, eight a warp,
// and read every stream's cache rows from L2, to use only its own W_o
// input; spread, each unit is attended once and the grid pays one more
// barrier.  B = 1 keeps phase 2 whole: its 16 tasks fill a block's warps
// once, and the barrier would only add to them.  The "s8" instantiations
// keep it whole too: their W_o input's per-stream maxima come with the
// attention, in every block, which a spread phase would have to publish.
// Position 0's last layer stops after W_qkv and the cache row: its output
// is discarded.  Block i owns the same output rows of every matrix at every
// layer and position (a contiguous range, so its rows are one contiguous
// span of bytes) and the same lanes of the sampler.  Weights do not depend
// on the activations, so the copy engine (cp.async.bulk, counted on an
// mbarrier) brings the rows, scales and norm weight a block owns in its
// next weighted phase into shared memory while the current phase computes
// and the barrier waits: two slots where shared memory allows, else one,
// filled before the barrier.  A phase issues that copy only after its own
// reads have landed, so they do not queue behind it.  After a barrier a
// phase waits only for its activations, one read from L2, with 16-byte
// loads.  The residual rows a block owns stay in its registers.  int8
// weights become floats by a byte permute and an add, not the quarter-rate
// convert.  A row's K is split over the warps of its block when there are
// fewer rows than warps; every sum, within a block or across the warps of
// one, is taken in one fixed order, so no float atomics are used, two calls
// give bit-identical results, and the work that every block repeats rather
// than pay for a barrier (the RMSNorm statistics, at B = 1 and in "s8" the
// attention over at most K cached rows, the penalty and softmax over the Vr
// lanes) gives the same values in every block.  Cross-block data (residual,
// projections, attention output, logits, candidates, cache) is read with
// ld.global.cg, from L2, never from a stale L1 line.
#include <cooperative_groups.h>

#include "persistent.cuh"

enum {
  kH, kA0, kPrev, kGumbel, kTemp, kTopP, kRep, kRope,
  kAttnNorm, kFfnNorm, kWqkv, kWqkvS, kWo, kWoS, kW1, kW1S, kW3, kW3S, kW2, kW2S,
  kFastNorm, kHead, kHeadS, kEmb, kEmbS, kCodes, kLogitsOut,
  kScratch, kClock, kSkip, kTrace, kTraceSc, kNumPtrs
};
enum {
  kB, kK, kL, kD, kHeads, kHkv, kDh, kI, kVr, kW, kHBf16, kCandCap, kClockCap, kScratchFloats,
  kS8, kTraceCap, kNumDims
};

namespace fts {
namespace {

namespace cg = cooperative_groups;

constexpr int kFastThreads = kThreads;
constexpr int kFastWarps = kWarps;
constexpr int kMaxWindow = 64;
constexpr int kMaxPos = 12;           // codebook positions per frame
constexpr int kMaxFastHeadDim = 64;   // one RoPE pair per lane

// The weighted phases: the matrix (or pair) whose owned rows a phase reads.
enum WKind { kNoWeights = -1, kQkvW = 0, kWoW = 1, kW13W = 2, kW2W = 3, kHeadW = 4 };
// Where a layer's input comes from: the residual stream, the projected slow
// hidden state (position 0), or the embedding of each stream's code.
enum Source { kFromX = 0, kFromH = 1, kFromEmb = 2 };

struct FastArgs {
  const void* h;  // (B, D) f32 or bf16
  const int* a0;
  const int* prev;
  const float* gumbel;
  const float* temp;
  const float* top_p;
  const float* rep;
  const __nv_bfloat16* rope;
  const float* attn_norm;
  const float* ffn_norm;
  const int8_t* wqkv; const float* wqkv_s;
  const int8_t* wo; const float* wo_s;
  const int8_t* w1; const float* w1_s;
  const int8_t* w3; const float* w3_s;
  const int8_t* w2; const float* w2_s;
  const float* fast_norm;
  const int8_t* head; const float* head_s;
  const int8_t* emb; const float* emb_s;
  int* codes;
  float* logits_out;
  float* x;         // (B, D) residual stream
  float* qkv;       // (B, H*Dh + 2*Hkv*Dh)
  float* hbuf;      // (B, I) SwiGLU hidden
  float* kc;        // (L, B, Hkv, K, Dh) per-frame cache
  float* vc;
  float* head_buf;  // (B, Vr) head logits
  __nv_bfloat16* obuf;  // (B, H*Dh) the spread attention's output, W_o's input
  float* cand_v;    // (grid, B) best Gumbel score of each block's lanes
  int* cand_i;
  unsigned long long* clock;  // (grid, clock_cap) barrier times, or nullptr
  const unsigned char* skip;  // the frame's skip flag, or nullptr
  // the s8 variant's trace, or nullptr: block 0 copies each quantized
  // activation row (trace_cap x B x the widest GEMV input, int8) and its
  // scales (trace_cap x B), in the order the rows are made
  int8_t* trace;
  float* trace_sc;
  float* smax;  // (grid, B) the s8 variant's per-block maxima of the SwiGLU rows
  int B, K, L, D, H, Hkv, Dh, I, Vr, W, h_bf16, clock_cap, trace_cap;
  int wslots;        // weight slots in shared memory: 1 or 2
  int wslot_bytes;   // bytes of one slot
  int wslot_offset;  // byte offset of the first slot
  float eps;
};

// Dynamic shared memory, in order:
//   act    one of: the bf16 staging of a GEMV's input (B x its K); that of a
//          normed input (B x D) with the f32 input itself at xf_offset; the
//          sampler's penalized logits and probabilities (2 x B x Vr f32).
//          In the s8 variant the staging is int8 (B rows of its K at a
//          stride of s8_ld(K)), the f32 region at xf_offset holds the
//          normed phases' input or the attention output (B x max(D, H*Dh)),
//          and the W_2 phase's ring of L2 reads follows the widest staging
//   part   the GEMV's partial sums (and the sampler's per-lane scores)
//   bits   the penalty window of the next sampled position, a bit per lane
//   gum    its Gumbel noise at the lanes this block owns
//   slots  one or two weight slots (the launch sizes them)
__host__ __device__ inline size_t xf_offset(int B, int D, int q_size, bool s8) {
  if (s8) return round16((size_t)B * s8_ld(D > q_size ? D : q_size));
  return round16((size_t)B * D * sizeof(__nv_bfloat16));
}
// the s8 variant's ring of L2 reads (quantize_l2_rows_s8) sits after its staging
__host__ __device__ inline size_t s8_ring_offset(int B, int max_k) {
  return round16((size_t)B * s8_ld(max_k));
}
__host__ __device__ inline size_t act_bytes(int B, int D, int q_size, int max_k, int Vr,
                                            bool s8) {
  size_t a = s8 ? s8_ring_offset(B, max_k) + sizeof(float4) * kS8Ring * kThreads
                : (size_t)B * max_k * sizeof(__nv_bfloat16);
  const size_t s = (size_t)B * Vr * 2 * sizeof(float);
  const size_t n = xf_offset(B, D, q_size, s8) +
                   (size_t)B * (s8 && q_size > D ? q_size : D) * sizeof(float);
  a = a > s ? a : s;
  a = a > n ? a : n;
  return round16(a);
}
__host__ __device__ inline size_t bits_bytes(int B, int Vr) {
  return round16((size_t)B * ((Vr + 31) / 32) * sizeof(unsigned));
}

// own[2 * kind], own[2 * kind + 1]: the rows this block owns in each kind.
__device__ Span phase_span(const FastArgs& a, int kind, int l, const int* own) {
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
  } else if (kind == kW2W) {
    sp.w = a.w2 + (size_t)l * a.D * a.I; sp.s = a.w2_s + (size_t)l * a.D;
    sp.N = a.D; sp.K = a.I;
  } else {
    sp.w = a.head; sp.s = a.head_s;
    sp.norm = a.fast_norm;
    sp.N = a.Vr; sp.K = a.D;
  }
  sp.r0 = own[2 * kind];
  sp.r1 = own[2 * kind + 1];
  return sp;
}

// The weighted phase after (pos, kind, l) in the frame, or kNoWeights.
__device__ void next_weighted(const FastArgs& a, int pos, int kind, int l, int& nkind, int& nl) {
  nl = l;
  if (kind == kQkvW) {
    if (pos == 0 && l == a.L - 1) {  // position 0 stops after its last W_qkv
      nkind = kQkvW;
      nl = 0;
    } else {
      nkind = kWoW;
    }
  } else if (kind == kWoW) {
    nkind = kW13W;
  } else if (kind == kW13W) {
    nkind = kW2W;
  } else if (kind == kW2W) {
    nkind = l + 1 < a.L ? kQkvW : kHeadW;
    nl = l + 1 < a.L ? l + 1 : 0;
  } else {
    nkind = pos + 1 < a.K ? kQkvW : kNoWeights;
    nl = 0;
  }
}

// amax[b] = max_k v[b, k] and lse[b] = log(sum_k exp(v[b, k] - amax[b]))
// + amax[b] in one pass: each thread keeps (max, sum of exp below it) over
// its lanes, and pairs merge, rescaling the smaller side, over the warp and
// then over the warps in a fixed butterfly, so every block gets the same
// bits.
__device__ __forceinline__ void merge_max_sum(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}
__device__ void rows_softmax_stats(const float* v, int B, int n, float* red, float* amax,
                                   float* lse) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* red_s = red + kMaxBatch * kFastWarps;
  for (int b = 0; b < B; ++b) {
    float m = -FLT_MAX, s = 0.f;
    for (int k = warp * 32 + lane; k < n; k += kFastThreads) m = fmaxf(m, v[(size_t)b * n + k]);
    for (int k = warp * 32 + lane; k < n; k += kFastThreads) s += expf(v[(size_t)b * n + k] - m);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
      const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
      merge_max_sum(m, s, m2, s2);
    }
    if (lane == 0) {
      red[b * kFastWarps + warp] = m;
      red_s[b * kFastWarps + warp] = s;
    }
  }
  __syncthreads();
  for (int b = warp; b < B; b += kFastWarps) {
    float m = lane < kFastWarps ? red[b * kFastWarps + lane] : -FLT_MAX;
    float s = lane < kFastWarps ? red_s[b * kFastWarps + lane] : 0.f;
#pragma unroll
    for (int o = kFastWarps / 2; o > 0; o >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
      const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
      merge_max_sum(m, s, m2, s2);
    }
    if (lane == 0) {
      amax[b] = m;
      lse[b] = logf(s) + m;
    }
  }
  __syncthreads();
}

// xf[b, k] = the input, then the staging of the normed input
// n[b, k] = xf[b, k] * rstd_b * nw[k], with rstd_b the RMSNorm scale of
// row b and nw in shared memory: bf16(n) into xs, or in the s8 variant n
// quantized into the int8 xs with its row scales in xsc and their
// reciprocals in xrc (a pass for the absmax, then one that quantizes, four
// lanes a thread).  The input is
// read once, by all threads at once.
template <bool S8>
__device__ __forceinline__ void stage_norm(const FastArgs& a, int src, const int* code,
                                           const float* nw, void* stage, float* xf,
                                           float* red, float* rstd, float* xsc, float* xrc) {
  const int B = a.B, D = a.D;
  for (int i = threadIdx.x; i < B * D / 4; i += kFastThreads) {  // 4 lanes at a time
    float4 v;
    if (src == kFromX) {
      v = __ldcg(reinterpret_cast<const float4*>(a.x) + i);
    } else if (src == kFromH && a.h_bf16) {
      const uint2 u = reinterpret_cast<const uint2*>(a.h)[i];
      const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
      const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
      v = make_float4(lo.x, lo.y, hi.x, hi.y);
    } else if (src == kFromH) {
      v = reinterpret_cast<const float4*>(a.h)[i];
    } else {
      const int b = 4 * i / D, c = code[b];
      const char4 q = *reinterpret_cast<const char4*>(a.emb + (size_t)c * D + (4 * i - b * D));
      const float sc = __ldg(a.emb_s + c);
      v = make_float4((float)q.x * sc, (float)q.y * sc, (float)q.z * sc, (float)q.w * sc);
    }
    reinterpret_cast<float4*>(xf)[i] = v;
  }
  __syncthreads();
  rms_scales(xf, B, D, a.eps, red, rstd);
  if constexpr (S8) {
    auto normed = [&](int b, int k4) {
      const float4 x = reinterpret_cast<const float4*>(xf + (size_t)b * D)[k4];
      const float4 w = reinterpret_cast<const float4*>(nw)[k4];
      const float r = rstd[b];
      return make_float4((x.x * r) * w.x, (x.y * r) * w.y, (x.z * r) * w.z, (x.w * r) * w.w);
    };
    row_scales_s8(normed, B, D / 4, xsc, xrc);
    quantize_rows_s8(normed, B, D / 4, xsc, xrc, static_cast<int8_t*>(stage), s8_ld(D));
  } else {
    __nv_bfloat16* xs = static_cast<__nv_bfloat16*>(stage);
    for (int i = threadIdx.x; i < B * D; i += kFastThreads) {
      const int b = i / D;
      xs[i] = __float2bfloat16_rn((xf[i] * rstd[b]) * nw[i - b * D]);
    }
    __syncthreads();
  }
}

// One query head's attention at position pos, by one warp (lane i holds
// dims (2i, 2i + 1); `on` for the lanes within Dh): the query qg roped
// here, the token's roped key ks and value vs, cache rows kr, vr (rows past
// pos hold zeros).  Returns the weighted sums of the two dims and the
// softmax's denominator (o.x, o.y, den); the output is o / den.
__device__ __forceinline__ float3 attend_head(float2 qg, const float* ks, float2 vs,
                                              const float2* kr, const float2* vr, int pos,
                                              const __nv_bfloat16* rope_row, int lane, bool on,
                                              float scale) {
  float q0 = 0.f, q1 = 0.f;
  if (on) rope_pair(qg.x, qg.y, rope_row, lane, &q0, &q1);
  const float s_self = warp_sum(fmaf(q1, ks[1], q0 * ks[0])) * scale;
  // every row's sum runs (rows past pos hold zeros) so that no shuffle
  // sits under a branch; they are masked after
  float sc[kMaxPos];
  float mx = s_self;
#pragma unroll
  for (int r = 0; r < kMaxPos; ++r) {
    sc[r] = warp_sum(fmaf(q1, kr[r].y, q0 * kr[r].x)) * scale;
    sc[r] = r < pos ? sc[r] : kNeg;
    mx = fmaxf(mx, sc[r]);
  }
  const float p_self = expf(s_self - mx);
  float den = p_self, o0 = p_self * vs.x, o1 = p_self * vs.y;
#pragma unroll
  for (int r = 0; r < kMaxPos; ++r) {
    if (r < pos) {
      const float p = expf(sc[r] - mx);
      den += p;
      o0 = fmaf(p, vr[r].x, o0);
      o1 = fmaf(p, vr[r].y, o1);
    }
  }
  return make_float3(o0, o1, den);
}

// Attention of every stream and query head at position pos (cache rows
// r < pos plus the token's own key), run in every block: the B = 1 and
// "s8" instantiations' phase 2.  The output goes
// to out (B, H*Dh), the input of W_o: bf16, or f32 in the s8 variant,
// which also takes each stream's max |output| into omax (zeroed by the
// caller) with one shared-memory atomicMax per task.  One warp per
// (stream, KV head, share of its G query heads), the shares as many as
// keep every warp busy; lane i holds dims (2i, 2i + 1).  Every load (own key and value, the
// queries, the cache rows) is issued before any score is formed, and
// after_loads() runs once the first task's loads have landed.  Block 0
// also writes the token's roped key and value into cache row pos.  At B = 1
// the tasks fill the block's warps once; in "s8" the maxima need the whole
// output in every block.  The batched "value" instantiations run
// attend_spread instead.
template <bool S8, typename F>
__device__ __forceinline__ void attend_all(const FastArgs& a, int l, int pos,
                                           const __nv_bfloat16* rope_s, void* out, float* omax,
                                           F after_loads) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int G = a.H / a.Hkv, q_size = a.H * a.Dh, kv_size = a.Hkv * a.Dh;
  const int nqkv = q_size + 2 * kv_size;
  int shares = kFastWarps / (a.B * a.Hkv);
  shares = shares < 1 ? 1 : (shares > G ? G : shares);
  while (G % shares != 0) --shares;
  const int gs = G / shares;  // query heads per task
  const bool on = lane < a.Dh / 2;
  const float scale = 1.0f / sqrtf((float)a.Dh);
  const __nv_bfloat16* rope_row = rope_s + pos * a.Dh;
  const size_t c_sh = (size_t)a.K * a.Dh, c_sb = c_sh * a.Hkv, c_sl = c_sb * a.B;
  bool first = true;
  for (int t = warp; t < a.B * a.Hkv * shares; t += kFastWarps) {
    const int bj = t / shares, g0 = (t - bj * shares) * gs;
    const int b = bj / a.Hkv, j = bj - b * a.Hkv;
    const float* row = a.qkv + (size_t)b * nqkv;
    const size_t cb = l * c_sl + b * c_sb + j * c_sh;
    float2 kk = make_float2(0.f, 0.f), vs = kk;
    float2 qq[2], kr[kMaxPos], vr[kMaxPos];
    if (on) {
      kk = __ldcg(reinterpret_cast<const float2*>(row + q_size + j * a.Dh) + lane);
      vs = __ldcg(reinterpret_cast<const float2*>(row + q_size + kv_size + j * a.Dh) + lane);
    }
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      qq[g] = make_float2(0.f, 0.f);
      if (g < gs && on)
        qq[g] = __ldcg(reinterpret_cast<const float2*>(row + (j * G + g0 + g) * a.Dh) + lane);
    }
#pragma unroll
    for (int r = 0; r < kMaxPos; ++r) {
      kr[r] = vr[r] = make_float2(0.f, 0.f);
      if (r < pos && on) {
        kr[r] = __ldcg(reinterpret_cast<const float2*>(a.kc + cb + (size_t)r * a.Dh) + lane);
        vr[r] = __ldcg(reinterpret_cast<const float2*>(a.vc + cb + (size_t)r * a.Dh) + lane);
      }
    }
    float ks[2] = {0.f, 0.f};
    if (on) rope_pair(kk.x, kk.y, rope_row, lane, &ks[0], &ks[1]);
    if (first) {
      // every load of this task is in use below; wait for them here
      float dep = ks[0] + vs.x + qq[0].x;
#pragma unroll
      for (int r = 0; r < kMaxPos; ++r) dep += kr[r].x + vr[r].y;
      asm volatile("add.f32 %0, %0, 0f00000000;" : "+f"(dep));
      after_loads();
      first = false;
    }
    if (blockIdx.x == 0 && on && g0 == 0) {
      const size_t at = cb + (size_t)pos * a.Dh + 2 * lane;
      __stcg(reinterpret_cast<float2*>(a.kc + at), make_float2(ks[0], ks[1]));
      __stcg(reinterpret_cast<float2*>(a.vc + at), vs);
    }
    float amx = 0.f;  // the s8 variant's max |output| of this task's lanes
    for (int g = 0; g < gs; ++g) {
      {
        if (g >= 2 && (g & 1) == 0) {  // the next pair of query heads
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            qq[h] = make_float2(0.f, 0.f);
            if (g + h < gs && on)
              qq[h] = __ldcg(reinterpret_cast<const float2*>(row + (j * G + g0 + g + h) * a.Dh) +
                             lane);
          }
        }
        const float2 qg = (g & 1) ? qq[1] : qq[0];
        const float3 acc = attend_head(qg, ks, vs, kr, vr, pos, rope_row, lane, on, scale);
        const float o0 = acc.x, o1 = acc.y, den = acc.z;
        if (on) {
          const size_t at = (size_t)b * q_size + (j * G + g0 + g) * a.Dh + 2 * lane;
          if constexpr (S8) {
            const float2 o = make_float2(o0 / den, o1 / den);
            *reinterpret_cast<float2*>(static_cast<float*>(out) + at) = o;
            amx = fmaxf(amx, fmaxf(fabsf(o.x), fabsf(o.y)));
          } else {
            __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out) + at;
            o[0] = __float2bfloat16_rn(o0 / den);
            o[1] = __float2bfloat16_rn(o1 / den);
          }
        }
      }
    }
    if constexpr (S8) {
      const float m = warp_max_pos(amx);
      if (lane == 0) atomicMax(reinterpret_cast<int*>(omax) + b, __float_as_int(m));
    }
  }
  if (first) after_loads();
  __syncthreads();
}

// The attention of the batched "value" instantiations (phase 2a), spread
// over the grid: unit u = b * H + h is stream b's query head h = j * G + g
// (KV head j), attended once, by the warp w = warp * gridDim.x + blockIdx.x
// with w = u mod (kFastWarps * gridDim.x), so that consecutive units land
// on distinct blocks.  A unit reads its query, its KV head's key and value
// and the cache rows r < pos once, from L2, and writes its output row,
// rounded to bf16 once, at obuf + u * Dh (row b, columns h * Dh of the W_o
// input); the unit with g = 0 writes the token's roped key and value into
// cache row pos.  after_loads() runs once the warp's first unit's loads
// have landed.
template <typename F>
__device__ __forceinline__ void attend_spread(const FastArgs& a, int l, int pos,
                                              const __nv_bfloat16* rope_s, F after_loads) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int G = a.H / a.Hkv, q_size = a.H * a.Dh, kv_size = a.Hkv * a.Dh;
  const int nqkv = q_size + 2 * kv_size;
  const bool on = lane < a.Dh / 2;
  const float scale = 1.0f / sqrtf((float)a.Dh);
  const __nv_bfloat16* rope_row = rope_s + pos * a.Dh;
  const size_t c_sh = (size_t)a.K * a.Dh, c_sb = c_sh * a.Hkv, c_sl = c_sb * a.B;
  bool first = true;
  for (int u = warp * gridDim.x + blockIdx.x; u < a.B * a.H; u += kFastWarps * gridDim.x) {
    const int b = u / a.H, h = u - b * a.H, j = h / G;
    const float* row = a.qkv + (size_t)b * nqkv;
    const size_t cb = l * c_sl + b * c_sb + j * c_sh;
    float2 kk = make_float2(0.f, 0.f), vs = kk, qg = kk, kr[kMaxPos], vr[kMaxPos];
    if (on) {
      kk = __ldcg(reinterpret_cast<const float2*>(row + q_size + j * a.Dh) + lane);
      vs = __ldcg(reinterpret_cast<const float2*>(row + q_size + kv_size + j * a.Dh) + lane);
      qg = __ldcg(reinterpret_cast<const float2*>(row + h * a.Dh) + lane);
    }
#pragma unroll
    for (int r = 0; r < kMaxPos; ++r) {
      kr[r] = vr[r] = make_float2(0.f, 0.f);
      if (r < pos && on) {
        kr[r] = __ldcg(reinterpret_cast<const float2*>(a.kc + cb + (size_t)r * a.Dh) + lane);
        vr[r] = __ldcg(reinterpret_cast<const float2*>(a.vc + cb + (size_t)r * a.Dh) + lane);
      }
    }
    float ks[2] = {0.f, 0.f};
    if (on) rope_pair(kk.x, kk.y, rope_row, lane, &ks[0], &ks[1]);
    if (first) {
      // every load of this unit is in use below; wait for them here
      float dep = ks[0] + vs.x + qg.x;
#pragma unroll
      for (int r = 0; r < kMaxPos; ++r) dep += kr[r].x + vr[r].y;
      asm volatile("add.f32 %0, %0, 0f00000000;" : "+f"(dep));
      after_loads();
      first = false;
    }
    if (on && h == j * G) {
      const size_t at = cb + (size_t)pos * a.Dh + 2 * lane;
      __stcg(reinterpret_cast<float2*>(a.kc + at), make_float2(ks[0], ks[1]));
      __stcg(reinterpret_cast<float2*>(a.vc + at), vs);
    }
    const float3 acc = attend_head(qg, ks, vs, kr, vr, pos, rope_row, lane, on, scale);
    if (on) {
      const __nv_bfloat162 o = __floats2bfloat162_rn(acc.x / acc.z, acc.y / acc.z);
      __stcg(reinterpret_cast<unsigned*>(a.obuf + (size_t)u * a.Dh) + lane,
             *reinterpret_cast<const unsigned*>(&o));
    }
  }
  if (first) after_loads();
}

// Block 0 writes the token's key and value into cache row pos of layer l
// (position 0's last layer, which runs no attention).
__device__ void write_cache_row(const FastArgs& a, int l, int pos, const __nv_bfloat16* rope_s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q_size = a.H * a.Dh, kv_size = a.Hkv * a.Dh;
  const size_t c_sh = (size_t)a.K * a.Dh, c_sb = c_sh * a.Hkv, c_sl = c_sb * a.B;
  for (int t = warp; t < a.B * a.Hkv && lane < a.Dh / 2; t += kFastWarps) {
    const int b = t / a.Hkv, j = t - b * a.Hkv;
    const float* row = a.qkv + (size_t)b * (q_size + 2 * kv_size);
    const float2 kk = __ldcg(reinterpret_cast<const float2*>(row + q_size + j * a.Dh) + lane);
    const float2 vv =
        __ldcg(reinterpret_cast<const float2*>(row + q_size + kv_size + j * a.Dh) + lane);
    float k0, k1;
    rope_pair(kk.x, kk.y, rope_s + pos * a.Dh, lane, &k0, &k1);
    const size_t at = l * c_sl + b * c_sb + j * c_sh + (size_t)pos * a.Dh + 2 * lane;
    __stcg(reinterpret_cast<float2*>(a.kc + at), make_float2(k0, k1));
    __stcg(reinterpret_cast<float2*>(a.vc + at), vv);
  }
}

// Phase 6 at codebook position cb: the penalty and softmax over all Vr
// lanes of every stream (every block, the same order), then the pairwise
// top-p rule and Gumbel score for the lanes this block owns; its best
// (score, lane) per stream goes to cand_v/cand_i, ties to the lowest lane.
// bits and gum were filled during the head phase; samp holds the clamped
// temperature, top_p and penalty of each stream.
__device__ __forceinline__ void sample_share(const FastArgs& a, int cb, float* lv, float* cand,
                                             const unsigned* bits, const float* gum,
                                             const float* samp, float* red, float* stat) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int B = a.B, Vr = a.Vr, R = a.K - 1;
  const int nw = (Vr + 31) / 32;
  float* pv = lv + (size_t)B * Vr;
  float* amax = stat;
  float* lse = stat + kMaxBatch;
  for (int i = threadIdx.x; i < B * Vr / 4; i += kFastThreads) {  // 4 lanes at a time
    const int b = 4 * i / Vr, v0 = 4 * i - b * Vr;
    const float4 h4 = __ldcg(reinterpret_cast<const float4*>(a.head_buf) + i);
    float l4[4] = {h4.x, h4.y, h4.z, h4.w};
    const float r_pen = samp[2 * kMaxBatch + b];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int v = v0 + k;
      if ((bits[b * nw + v / 32] >> (v % 32)) & 1u)
        l4[k] = l4[k] < 0.f ? l4[k] * r_pen : l4[k] / r_pen;
    }
    const float4 o4 = make_float4(l4[0], l4[1], l4[2], l4[3]);
    reinterpret_cast<float4*>(lv)[i] = o4;
    if (blockIdx.x == 0)
      reinterpret_cast<float4*>(a.logits_out + ((size_t)b * R + cb - 1) * Vr)[v0 / 4] = o4;
  }
  __syncthreads();
  rows_softmax_stats(lv, B, Vr, red, amax, lse);
  for (int i = threadIdx.x; i < B * Vr; i += kFastThreads) pv[i] = expf(lv[i] - lse[i / Vr]);
  __syncthreads();

  int i0, i1;
  owned(Vr, i0, i1);
  const int nl = i1 - i0;
  for (int t = warp; t < B * nl; t += kFastWarps) {
    const int b = t / nl, i = i0 + (t - b * nl);
    const float* lb = lv + (size_t)b * Vr;
    const float* pb = pv + (size_t)b * Vr;
    const float li = lb[i];
    const float4* l4 = reinterpret_cast<const float4*>(lb);
    const float4* p4 = reinterpret_cast<const float4*>(pb);
    float above = 0.f;
#pragma unroll 2
    for (int j = lane; j < Vr / 4; j += 32) {
      const float4 lj = l4[j], pj = p4[j];
      above += lj.x > li ? pj.x : 0.f;
      above += lj.y > li ? pj.y : 0.f;
      above += lj.z > li ? pj.z : 0.f;
      above += lj.w > li ? pj.w : 0.f;
    }
    above = warp_sum(above);
    if (lane == 0) {
      const float tp = samp[kMaxBatch + b];
      const bool keep = (above + pb[i] <= tp) || (li >= amax[b]) || (tp >= 1.0f);
      cand[t] = (keep ? li : kNeg) / samp[b] + gum[t];
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < B; b += kFastThreads) {
    float best = -FLT_MAX;
    int best_i = 0x7fffffff;
    for (int k = 0; k < nl; ++k) {
      if (cand[b * nl + k] > best) {
        best = cand[b * nl + k];
        best_i = i0 + k;
      }
    }
    __stcg(a.cand_v + (size_t)blockIdx.x * B + b, best);
    __stcg(a.cand_i + (size_t)blockIdx.x * B + b, best_i);
  }
}

// Every block merges the blocks' candidates: code[b] is the lane with the
// highest score, ties to the lowest lane (torch.argmax's first maximum).
// Block 0 writes it to codes[:, cb - 1].
__device__ void merge_codes(const FastArgs& a, int cb, int* code) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int B = a.B;
  for (int b = warp; b < B; b += kFastWarps) {
    float best = -FLT_MAX;
    int best_i = 0x7fffffff;
    for (int k = lane; k < (int)gridDim.x; k += 32) {
      const float v = __ldcg(a.cand_v + (size_t)k * B + b);
      const int i = __ldcg(a.cand_i + (size_t)k * B + b);
      if (v > best || (v == best && i < best_i)) {
        best = v;
        best_i = i;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, o);
      const int oi = __shfl_xor_sync(0xffffffffu, best_i, o);
      if (ov > best || (ov == best && oi < best_i)) {
        best = ov;
        best_i = oi;
      }
    }
    if (lane == 0) {
      code[b] = best_i;
      if (blockIdx.x == 0) a.codes[b * (a.K - 1) + cb - 1] = best_i;
    }
  }
  __syncthreads();
}

// S8: the "s8" dequant mode (int8 staging, int8 tensor-core GEMVs); else "value".
template <int MAXB, bool S8>
__global__ void __launch_bounds__(kFastThreads, 1) fast_frame_kernel(const FastArgs a) {
  // the batched "value" instantiations spread the attention over the grid
  constexpr bool kSpread = MAXB > 1 && !S8;
  // a skipped frame: every block reads the same flag before any barrier and
  // returns, so the grid leaves together and writes nothing
  if (a.skip != nullptr && *a.skip) return;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float rstd[kMaxBatch];
  __shared__ float xsc[kMaxBatch];  // the s8 staging's row scales
  __shared__ float xrc[kMaxBatch];  // their reciprocals
  // the s8 variant's per-stream maxima of the rows a phase computes
  __shared__ float pmax[kMaxBatch];
  __shared__ float stat[2 * kMaxBatch];
  __shared__ float samp[3 * kMaxBatch];  // clamped temperature, top_p, penalty
  __shared__ float red[2 * kMaxBatch * kFastWarps];
  __shared__ int code[kMaxBatch];
  __shared__ __nv_bfloat16 rope_s[kMaxPos * kMaxFastHeadDim];
  __shared__ __align__(8) unsigned long long bars[2];  // one per weight slot
  __shared__ int own[10];                              // owned rows of each kind

  const int B = a.B, D = a.D, I = a.I, L = a.L, K = a.K, Vr = a.Vr, R = K - 1;
  const int q_size = a.H * a.Dh;
  const int max_k = D > q_size ? (D > I ? D : I) : (q_size > I ? q_size : I);
  const size_t act = act_bytes(B, D, q_size, max_k, Vr, S8);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  int8_t* xq = reinterpret_cast<int8_t*>(smem);  // the s8 variant's staging
  void* stage = S8 ? static_cast<void*>(xq) : static_cast<void*>(xs);
  float* xf = reinterpret_cast<float*>(smem + xf_offset(B, D, q_size, S8));
  float* part = reinterpret_cast<float*>(smem + act);
  int* ipart = reinterpret_cast<int*>(part);  // the s8 GEMV's s32 partials
  unsigned* bits = reinterpret_cast<unsigned*>(smem + a.wslot_offset - bits_bytes(B, Vr) -
                                               round16((size_t)B * ((Vr + gridDim.x - 1) /
                                                                    gridDim.x) * sizeof(float)));
  float* gum = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(bits) +
                                        bits_bytes(B, Vr));
  unsigned char* wsm = smem + a.wslot_offset;

  // The residual rows this block owns: thread i < (rows) * B holds row
  // xr0 + i / B of stream i % B (the launch checks that they fit).
  int xr0, xr1;
  owned(D, xr0, xr1);
  const bool x_owner = (int)threadIdx.x < (xr1 - xr0) * B;
  const int xj = threadIdx.x / B, xb = threadIdx.x - xj * B;
  float x_own = 0.f;
  auto publish_x = [&]() {
    if (x_owner) __stcg(a.x + (size_t)xb * D + xr0 + xj, x_own);
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

  // weight slots: `cur` holds (or is receiving) the current phase's rows;
  // parity[s] is the phase of slot s's mbarrier that its next copy completes
  int cur = 0;
  unsigned parity[2] = {0u, 0u};
  auto slot = [&](int s) { return wsm + (size_t)s * a.wslot_bytes; };
  // the GEMV of a phase's owned rows (slot cur) against the staged input:
  // its partials (returns S), row r0 + j of stream b, the rows stored
  auto gemv = [&](const Span& sp) -> int {
    if constexpr (S8) return gemv_partials_s8<MAXB>(sp, slot(cur), xq, B, ipart);
    else return gemv_partials<MAXB>(sp, slot(cur), xs, B, part);
  };
  auto row = [&](const Span& sp, int S, int j, int b) -> float {
    if constexpr (S8) return row_value_s8<MAXB>(sp, slot(cur), ipart, S, j, b, xsc[b]).x;
    else return row_value<MAXB>(sp, slot(cur), part, S, j, b).x;
  };
  auto store = [&](const Span& sp, int S, float* out, int ld) {
    if constexpr (S8) store_rows_s8<MAXB>(sp, slot(cur), ipart, S, B, xsc, out, ld);
    else store_rows<MAXB>(sp, slot(cur), part, S, B, out, ld);
  };
  // after each s8 quantization of n-wide rows, with the block synchronised:
  // block 0 copies the rows and their scales to row t of the trace, the
  // input of matrix k (W_qkv, W_o, W_1/W_3, W_2) of layer l, or the head's
  // (l == L), in s8_trace_layout order
  auto trace = [&](int n, int pos, int l, int k) {
    if constexpr (S8) {
      const int t = (pos == 0 ? 0 : 4 * (L - 1) + 1 + (pos - 1) * (4 * L + 1)) + 4 * l + k;
      if (a.trace != nullptr && blockIdx.x == 0 && t < a.trace_cap) {
        int8_t* dst = a.trace + (size_t)t * B * max_k;
        const int ld = s8_ld(n);
#pragma unroll 1
        for (int b = 0; b < B; ++b) {
#pragma unroll 1
          for (int c = threadIdx.x; c < n / 16; c += kFastThreads)
            reinterpret_cast<int4*>(dst + (size_t)b * max_k)[c] =
                reinterpret_cast<const int4*>(xq + (size_t)b * ld)[c];
        }
        if ((int)threadIdx.x < B) a.trace_sc[t * B + threadIdx.x] = xsc[threadIdx.x];
      }
    }
  };
  // at a weighted phase's start: wait for this phase's copy
  auto begin = [&](int pos, int kind, int l) {
    bar_wait(&bars[cur], parity[cur]);
    parity[cur] ^= 1u;
    return phase_span(a, kind, l, own);
  };
  // with two slots, once the phase's own reads have landed (so that they
  // do not queue behind the copy), start the next phase's copy into the
  // other slot; thread 0 issues it
  auto prefetch = [&](int pos, int kind, int l) {
    if (a.wslots == 2 && threadIdx.x == 0) {
      int nk, nl;
      next_weighted(a, pos, kind, l, nk, nl);
      if (nk != kNoWeights)
        issue_copy(phase_span(a, nk, nl, own), slot(cur ^ 1), &bars[cur ^ 1], D);
    }
  };
  // at its end: with one slot, start the next phase's copy before the barrier
  auto finish = [&](int pos, int kind, int l) {
    if (a.wslots == 2) {
      cur ^= 1;
    } else {
      int nk, nl;
      next_weighted(a, pos, kind, l, nk, nl);
      __syncthreads();
      if (nk != kNoWeights) issue_copy(phase_span(a, nk, nl, own), slot(cur), &bars[cur], D);
    }
  };

  if (a.clock != nullptr) stamp(a.clock, a.clock_cap, n_stamp);
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(&bars[i])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (threadIdx.x < 5) {
    const int n[5] = {q_size + 2 * a.Hkv * a.Dh, D, I, D, Vr};  // in WKind order
    owned(n[threadIdx.x], own[2 * threadIdx.x], own[2 * threadIdx.x + 1]);
  }
  __syncthreads();
  issue_copy(phase_span(a, kQkvW, 0, own), slot(0), &bars[0], D);
  if (threadIdx.x < B) {
    const int b = threadIdx.x;
    code[b] = a.a0[b];
    samp[b] = fmaxf(a.temp[b], 1e-5f);
    samp[kMaxBatch + b] = a.top_p[b];
    samp[2 * kMaxBatch + b] = a.rep[b];
  }
  for (int i = threadIdx.x; i < K * a.Dh; i += kFastThreads) rope_s[i] = a.rope[i];
  __syncthreads();

  for (int pos = 0; pos < K; ++pos) {
    for (int l = 0; l < L; ++l) {
      // phase 1: RMSNorm + W_qkv
      Span sp = begin(pos, kQkvW, l);
      if (l == 0 && pos > 1) merge_codes(a, pos - 1, code);  // position 1 embeds a0
      stage_norm<S8>(a, l > 0 ? kFromX : (pos == 0 ? kFromH : kFromEmb), code,
                     slot_norm(sp, slot(cur)), stage, xf, red, rstd, xsc, xrc);
      trace(D, pos, l, 0);
      prefetch(pos, kQkvW, l);
      if (l == 0) {
        if (x_owner) x_own = xf[xb * D + xr0 + xj];
        publish_x();
      }
      int S = gemv(sp);
      store(sp, S, a.qkv, sp.N);
      finish(pos, kQkvW, l);
      barrier();
      if (pos == 0 && l == L - 1) {
        // position 0's output is discarded: its last layer only fills the cache
        if (blockIdx.x == 0) write_cache_row(a, l, pos, rope_s);
        barrier();
        break;
      }

      if constexpr (kSpread) {
        // phase 2a: attention, each (stream, query head) once on the grid;
        // the copy of the phase after W_o starts once the loads have landed
        attend_spread(a, l, pos, rope_s, [&]() { prefetch(pos, kWoW, l); });
        barrier();

        // phase 2b: W_o + residual, its input read from L2 once
        sp = begin(pos, kWoW, l);
        for (int i = threadIdx.x; i < B * q_size / 8; i += kFastThreads)
          reinterpret_cast<int4*>(xs)[i] = __ldcg(reinterpret_cast<const int4*>(a.obuf) + i);
        __syncthreads();
      } else {
        // phase 2: attention + W_o + residual
        sp = begin(pos, kWoW, l);
        if constexpr (S8) {
          if ((int)threadIdx.x < B) pmax[threadIdx.x] = 0.f;
          __syncthreads();
        }
        attend_all<S8>(a, l, pos, rope_s, S8 ? static_cast<void*>(xf) : stage, pmax,
                       [&]() { prefetch(pos, kWoW, l); });
        if constexpr (S8) {
          // the scales of the maxima attend_all took as it wrote the output
          if ((int)threadIdx.x < B) set_scale_s8(threadIdx.x, pmax[threadIdx.x], xsc, xrc);
          __syncthreads();
          auto att = [&](int b, int k4) {
            return reinterpret_cast<const float4*>(xf + (size_t)b * q_size)[k4];
          };
          quantize_rows_s8(att, B, q_size / 4, xsc, xrc, xq, s8_ld(q_size));
          trace(q_size, pos, l, 1);
        }
      }
      S = gemv(sp);
      if (x_owner) x_own += row(sp, S, xj, xb);
      publish_x();
      finish(pos, kWoW, l);
      barrier();

      // phase 3: RMSNorm + W_1/W_3 SwiGLU
      sp = begin(pos, kW13W, l);
      stage_norm<S8>(a, kFromX, code, slot_norm(sp, slot(cur)), stage, xf, red, rstd, xsc,
                     xrc);
      trace(D, pos, l, 2);
      prefetch(pos, kW13W, l);
      S = gemv(sp);
      if constexpr (S8)  // with each block's maxima of the rows it stores
        store_rows_s8<MAXB>(sp, slot(cur), ipart, S, B, xsc, a.hbuf, I, pmax, a.smax);
      else
        store(sp, S, a.hbuf, I);
      finish(pos, kW13W, l);
      barrier();

      // phase 4: W_2 + residual
      sp = begin(pos, kW2W, l);
      if constexpr (S8) {
        // the SwiGLU product read from L2 once, its scales from the maxima
        // the W_1/W_3 phase published
        quantize_l2_rows_s8(a.hbuf, a.smax, B, I / 4, xsc, xrc, xq, s8_ld(I),
                            reinterpret_cast<float4*>(smem + s8_ring_offset(B, max_k)));
        trace(I, pos, l, 3);
      } else {
        for (int i = threadIdx.x; i < B * I / 4; i += kFastThreads) {
          const float4 v = __ldcg(reinterpret_cast<const float4*>(a.hbuf) + i);
          reinterpret_cast<__nv_bfloat162*>(xs)[2 * i] = __floats2bfloat162_rn(v.x, v.y);
          reinterpret_cast<__nv_bfloat162*>(xs)[2 * i + 1] = __floats2bfloat162_rn(v.z, v.w);
        }
        __syncthreads();
      }
      prefetch(pos, kW2W, l);
      S = gemv(sp);
      if (x_owner) x_own += row(sp, S, xj, xb);
      publish_x();
      finish(pos, kW2W, l);
      barrier();
    }
    if (pos == 0) continue;

    // phase 5: fast_norm + head over the first Vr rows; meanwhile the
    // sampler's inputs for this position (penalty window, owned noise)
    Span sp = begin(pos, kHeadW, 0);
    int i0, i1;
    owned(Vr, i0, i1);
    const int nl = i1 - i0, nw = (Vr + 31) / 32;
    for (int i = threadIdx.x; i < B * nw; i += kFastThreads) bits[i] = 0u;
    float g_own = 0.f;  // the launch checks B * nl <= kFastThreads
    if ((int)threadIdx.x < B * nl) {
      const int b = threadIdx.x / nl;
      g_own = __ldg(a.gumbel + ((size_t)b * R + pos - 1) * Vr + i0 + (threadIdx.x - b * nl));
    }
    int win[2] = {-1, -1};  // B * W <= 2 * kFastThreads window entries
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = threadIdx.x + e * kFastThreads;
      if (i < B * a.W) {
        const int b = i / a.W;
        win[e] = b * Vr + __ldg(a.prev + ((size_t)b * R + pos - 1) * a.W + (i - b * a.W));
        if (win[e] < b * Vr || win[e] >= (b + 1) * Vr) win[e] = -1;  // names no lane
      }
    }
    stage_norm<S8>(a, kFromX, code, slot_norm(sp, slot(cur)), stage, xf, red, rstd, xsc,
                   xrc);
    trace(D, pos, L, 0);
    prefetch(pos, kHeadW, 0);
    if ((int)threadIdx.x < B * nl) gum[threadIdx.x] = g_own;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (win[e] >= 0) {
        const int b = win[e] / Vr, v = win[e] - b * Vr;
        atomicOr(&bits[b * nw + v / 32], 1u << (v % 32));
      }
    }
    const int S = gemv(sp);
    store(sp, S, a.head_buf, Vr);
    finish(pos, kHeadW, 0);
    barrier();

    // phase 6: penalty, softmax, pairwise top-p and Gumbel score of owned lanes
    sample_share(a, pos, reinterpret_cast<float*>(smem), part, bits, gum, samp, red, stat);
    barrier();
  }
  merge_codes(a, K - 1, code);
}

template <int MAXB, bool S8>
cudaError_t launch_frame(FastArgs& fa, int cand_cap, cudaStream_t st) {
  auto kern = fast_frame_kernel<MAXB, S8>;
  const int q_size = fa.H * fa.Dh, nqkv = q_size + 2 * fa.Hkv * fa.Dh;
  int max_k = fa.D > q_size ? fa.D : q_size;
  max_k = max_k > fa.I ? max_k : fa.I;
  const int sms = num_sms();
  // Shared memory is sized for one block per SM, the most rows per block:
  // a larger grid only owns fewer.
  auto rows = [&](int n) { return (size_t)(n + sms - 1) / sms; };
  if ((rows(fa.D) > rows(fa.Vr) ? rows(fa.D) : rows(fa.Vr)) * fa.B > (size_t)kFastThreads)
    return cudaErrorInvalidValue;
  size_t slot = rows(nqkv) * fa.D;
  const size_t phase_bytes[] = {rows(fa.D) * q_size, 2 * rows(fa.I) * fa.D, rows(fa.D) * fa.I,
                                rows(fa.Vr) * fa.D};
  for (size_t b : phase_bytes) slot = slot > b ? slot : b;
  if (S8) {  // the s8 GEMV reads whole n8 tiles of rows
    auto tiled = [&](int n) { return (rows(n) + 7) / 8 * 8; };
    const size_t tile_bytes[] = {tiled(nqkv) * fa.D, tiled(fa.D) * q_size,
                                 2 * tiled(fa.I) * fa.D, tiled(fa.D) * fa.I, tiled(fa.Vr) * fa.D};
    for (size_t b : tile_bytes) slot = slot > b ? slot : b;
  }
  size_t max_rows = rows(nqkv);
  for (int n : {fa.D, fa.I, fa.Vr}) max_rows = max_rows > rows(n) ? max_rows : rows(n);
  slot += 2 * round16(max_rows * sizeof(float) + 16) + fa.D * sizeof(float);  // scales, norm
  slot = round16(slot);
  // segment partial sums: at most max(rows per block, warps) tasks; the
  // sampler's per-lane scores reuse the same space
  const size_t tasks = max_rows + kFastWarps;
  size_t part_bytes = round16(tasks * 2 * MAXB * sizeof(float));
  if (S8) {  // the s8 GEMV's s32 tiles: MAXB x 8 a task, at most max(kWarps, tiles) tasks
    const size_t tiles = 2 * ((max_rows + 7) / 8);
    const size_t t = tiles > (size_t)kFastWarps ? tiles : (size_t)kFastWarps;
    part_bytes = part_bytes > t * MAXB * 8 * sizeof(int) ? part_bytes : t * MAXB * 8 * sizeof(int);
  }
  const size_t base = act_bytes(fa.B, fa.D, q_size, max_k, fa.Vr, S8) + part_bytes +
                      bits_bytes(fa.B, fa.Vr) +
                      round16((size_t)fa.B * rows(fa.Vr) * sizeof(float));

  // the device's and the kernel's shared memory limits, and the occupancy
  // at the last size asked for, are looked up once per instantiation
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
  fa.wslots = base + 2 * slot <= avail ? 2 : 1;
  if (base + slot > avail) return cudaErrorInvalidValue;
  fa.wslot_bytes = (int)slot;
  fa.wslot_offset = (int)base;
  const size_t smem = base + fa.wslots * slot;
  if (smem != last_smem) {
    if ((e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
      return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kFastThreads, smem);
    if (e != cudaSuccess) return e;
    last_smem = smem;
  }
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int grid = per_sm * sms;
  if ((long long)grid * fa.B > cand_cap) return cudaErrorInvalidValue;
  void* args[] = {&fa};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern), dim3(grid),
                                     dim3(kFastThreads), args, smem, st);
}

}  // namespace
}  // namespace fts

// ptrs/dims in the order of the enums above (dims[kS8] != 0 selects the
// "s8" variant); returns a cudaError_t.
extern "C" int fts_fast_decode_frame(void* const* p, const int* d, float eps, void* stream) {
  using namespace fts;
  FastArgs a;
  a.B = d[kB]; a.K = d[kK]; a.L = d[kL]; a.D = d[kD]; a.H = d[kHeads]; a.Hkv = d[kHkv];
  a.Dh = d[kDh]; a.I = d[kI]; a.Vr = d[kVr]; a.W = d[kW]; a.h_bf16 = d[kHBf16];
  a.clock_cap = d[kClockCap];
  a.trace_cap = d[kTraceCap];
  a.eps = eps;
  if (a.Dh > kMaxFastHeadDim || a.Dh % 2 != 0 || a.H % a.Hkv != 0 || a.B < 1 ||
      a.B > kMaxBatch || a.W > kMaxWindow || a.K < 2 || a.K > kMaxPos ||
      a.D % 16 != 0 || a.I % 16 != 0 || (a.H * a.Dh) % 16 != 0 || a.Vr % 4 != 0 ||
      (a.Hkv * a.Dh) % 2 != 0)
    return (int)cudaErrorInvalidValue;
  a.h = p[kH];
  a.a0 = static_cast<const int*>(p[kA0]);
  a.prev = static_cast<const int*>(p[kPrev]);
  a.gumbel = static_cast<const float*>(p[kGumbel]);
  a.temp = static_cast<const float*>(p[kTemp]);
  a.top_p = static_cast<const float*>(p[kTopP]);
  a.rep = static_cast<const float*>(p[kRep]);
  a.rope = static_cast<const __nv_bfloat16*>(p[kRope]);
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
  a.fast_norm = static_cast<const float*>(p[kFastNorm]);
  a.head = static_cast<const int8_t*>(p[kHead]);
  a.head_s = static_cast<const float*>(p[kHeadS]);
  a.emb = static_cast<const int8_t*>(p[kEmb]);
  a.emb_s = static_cast<const float*>(p[kEmbS]);
  a.codes = static_cast<int*>(p[kCodes]);
  a.logits_out = static_cast<float*>(p[kLogitsOut]);
  // scratch, each part a multiple of 4 floats: x (B, D), qkv, the SwiGLU
  // hidden (B, I), the K and V caches (L, B, Hkv, K, Dh), the head logits
  // (B, Vr), the candidates' scores and lanes, the s8 variant's published
  // maxima (cap each), and the spread attention's bf16 output (B, H*Dh)
  const int cap = d[kCandCap];
  const long long parts[] = {(long long)a.B * a.D,
                             (long long)a.B * (a.H + 2 * a.Hkv) * a.Dh,
                             (long long)a.B * a.I,
                             (long long)a.L * a.B * a.Hkv * a.K * a.Dh,
                             (long long)a.L * a.B * a.Hkv * a.K * a.Dh,
                             (long long)a.B * a.Vr, cap, cap, cap,
                             (long long)a.B * a.H * a.Dh / 2};
  float* at[10];
  long long used = 0;
  for (int i = 0; i < 10; ++i) {
    at[i] = static_cast<float*>(p[kScratch]) + used;
    used += (parts[i] + 3) / 4 * 4;
  }
  if (used > d[kScratchFloats]) return (int)cudaErrorInvalidValue;
  a.x = at[0];
  a.qkv = at[1];
  a.hbuf = at[2];
  a.kc = at[3];
  a.vc = at[4];
  a.head_buf = at[5];
  a.cand_v = at[6];
  a.cand_i = reinterpret_cast<int*>(at[7]);
  a.smax = at[8];
  a.obuf = reinterpret_cast<__nv_bfloat16*>(at[9]);
  a.clock = static_cast<unsigned long long*>(p[kClock]);
  a.skip = static_cast<const unsigned char*>(p[kSkip]);
  a.trace = static_cast<int8_t*>(p[kTrace]);
  a.trace_sc = static_cast<float*>(p[kTraceSc]);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d[kS8]) {
    if (a.B <= 1) return (int)launch_frame<1, true>(a, cap, st);
    if (a.B <= 4) return (int)launch_frame<4, true>(a, cap, st);
    return (int)launch_frame<16, true>(a, cap, st);
  }
  if (a.B <= 1) return (int)launch_frame<1, false>(a, cap, st);
  if (a.B <= 4) return (int)launch_frame<4, false>(a, cap, st);
  return (int)launch_frame<16, false>(a, cap, st);
}
