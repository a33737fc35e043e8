// Building blocks of the persistent cooperative kernels (fast_decoder.cu,
// slow_stack.cu): one block of kThreads threads per share of the grid,
// phases separated by grid-wide barriers.
//
// - owned(): the contiguous range of rows (or lanes) a block owns; block i
//   owns the same rows of a matrix at every layer, so its rows are one
//   contiguous span of bytes.
// - Span, issue_copy(), bar_wait(): the copy engine (cp.async.bulk counted
//   on an mbarrier) brings a phase's owned rows, scales and RMSNorm weight
//   into a shared-memory slot ahead of the phase.
// - int8x16_to_float(), fma_chunk(), gemv_partials(), row_value(),
//   store_rows(): the int8 GEMV of the owned rows against a bf16 staging of
//   the input, every sum in one fixed order.
// - row_scales_s8(), fold_scales_s8(), quantize_rows_s8(),
//   gemv_partials_s8(), row_value_s8(), store_rows_s8(): the same GEMV
//   against an int8 staging of the input (per-row absmax scale, from a pass
//   over the row or from maxima its writers published), mma.sync s8 x s8
//   into s32 on the tensor cores.
// - rms_scales(): RMSNorm statistics folded in a fixed order, so every
//   block that repeats them gets the same bits.
// - stamp(): the phase clock, the global timer at each barrier.
#pragma once

#include "common.cuh"

namespace fts {
namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

__host__ __device__ inline size_t round16(size_t n) { return (n + 15) & ~(size_t)15; }

// The contiguous range [r0, r1) of N rows (or lanes) that this block owns.
__device__ __forceinline__ void owned(int N, int& r0, int& r1) {
  r0 = (int)(blockIdx.x * (unsigned)N / gridDim.x);
  r1 = (int)((blockIdx.x + 1) * (unsigned)N / gridDim.x);
}

// Segments a row's K is cut into: more while the block has warps to spare
// and each segment keeps at least two 16-byte chunks per lane.
__device__ __forceinline__ int seg_count(int N, int K) {
  const int nr_max = (N + gridDim.x - 1) / gridDim.x;
  int S = 1;
  while (nr_max * S * 2 <= kWarps && (K / (S * 2)) % 16 == 0 && K / (S * 2) >= 1024) S *= 2;
  return S;
}

// The weights of one phase: its (N, K) int8 matrix and scales at layer l,
// the SwiGLU up matrix beside W_1, the RMSNorm weight of its input (or
// none), and the rows this block owns.
struct Span {
  const int8_t* w;
  const float* s;
  const int8_t* wu;
  const float* su;
  const float* norm;
  int N, K, r0, r1;
};

// Slot layout (a bulk copy moves 16-byte-aligned spans): the owned rows of
// w, then of wu (r1 - r0 rows of K bytes each), the 16-byte-aligned span
// holding s[r0, r1), the same for su, then the D-float RMSNorm weight.
__device__ __forceinline__ int rows_bytes(const Span& sp) { return (sp.r1 - sp.r0) * sp.K; }
__device__ __forceinline__ int scale_region(const Span& sp) {
  return (int)round16((size_t)(sp.r1 - sp.r0) * sizeof(float) + 16);
}
__device__ __forceinline__ const float* aligned_down(const float* p) {
  return reinterpret_cast<const float*>(reinterpret_cast<size_t>(p) & ~(size_t)15);
}
// s[r0 + j] is slot_scales(...)[j]; su[r0 + j] is slot_scales(..., true)[j].
__device__ __forceinline__ const float* slot_scales(const Span& sp, const unsigned char* slot,
                                                    bool up = false) {
  const int nmat = sp.wu != nullptr ? 2 : 1;
  const float* src = up ? sp.su : sp.s;
  const unsigned char* region = slot + nmat * rows_bytes(sp) + (up ? scale_region(sp) : 0);
  return reinterpret_cast<const float*>(region) + (src + sp.r0 - aligned_down(src + sp.r0));
}
__device__ __forceinline__ const float* slot_norm(const Span& sp, const unsigned char* slot) {
  const int nmat = sp.wu != nullptr ? 2 : 1;
  return reinterpret_cast<const float*>(slot + nmat * (rows_bytes(sp) + scale_region(sp)));
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One bulk copy of `bytes` (a multiple of 16) by the copy engine, counted
// on the slot's mbarrier.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Block until the slot's mbarrier completes the phase of the given parity.
__device__ __forceinline__ void bar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// Thread 0 starts the copy engine on the owned rows, scales and norm
// weight of a phase into a slot, all counted on the slot's mbarrier.  The
// slot's previous readers have passed a block barrier.
__device__ void issue_copy(const Span& sp, unsigned char* slot, unsigned long long* bar, int D) {
  if (threadIdx.x != 0) return;
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  const int nmat = sp.wu != nullptr ? 2 : 1;
  const unsigned rows = (unsigned)rows_bytes(sp);
  const bool any = sp.r1 > sp.r0;
  const float* s_lo = aligned_down(sp.s + sp.r0);
  const unsigned s_bytes =
      any ? (unsigned)round16(reinterpret_cast<size_t>(sp.s + sp.r1) -
                              reinterpret_cast<size_t>(s_lo))
          : 0u;
  const float* su_lo = nmat == 2 ? aligned_down(sp.su + sp.r0) : nullptr;
  const unsigned su_bytes =
      any && nmat == 2
          ? (unsigned)round16(reinterpret_cast<size_t>(sp.su + sp.r1) -
                              reinterpret_cast<size_t>(su_lo))
          : 0u;
  const unsigned norm_bytes = sp.norm != nullptr ? (unsigned)(D * sizeof(float)) : 0u;
  const unsigned total = nmat * rows + s_bytes + su_bytes + norm_bytes;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(total)
               : "memory");
  unsigned char* sreg = slot + nmat * rows;
  if (rows > 0) {
    bulk_copy(slot, sp.w + (size_t)sp.r0 * sp.K, rows, bar);
    if (nmat == 2) bulk_copy(slot + rows, sp.wu + (size_t)sp.r0 * sp.K, rows, bar);
  }
  if (s_bytes > 0) bulk_copy(sreg, s_lo, s_bytes, bar);
  if (su_bytes > 0) bulk_copy(sreg + scale_region(sp), su_lo, su_bytes, bar);
  if (norm_bytes > 0)
    bulk_copy(const_cast<float*>(slot_norm(sp, slot)), sp.norm, norm_bytes, bar);
}

// f[j] = (float)int8 byte j of v, exactly: the byte (biased by 128) goes
// into the low mantissa bits of 2^23 by a byte permute, and one add takes
// 2^23 + 128 away; cheaper than the quarter-rate int-to-float convert.
__device__ __forceinline__ void int8x16_to_float(const int4& v, float* f) {
  const unsigned w[4] = {(unsigned)v.x, (unsigned)v.y, (unsigned)v.z, (unsigned)v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const unsigned u = w[q] ^ 0x80808080u;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      f[4 * q + k] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | k)) - 8388736.0f;
  }
}

// acc[b] += sum_j x[b, k0 + j] * w[j] over one 16-byte chunk of a row (and
// the same for the SwiGLU up row); xk points at x[0, k0] in the staging.
template <int MAXB, bool UP>
__device__ __forceinline__ void fma_chunk(const int4& wv, const int4& uv,
                                          const __nv_bfloat16* xk, int K, int B, float* acc,
                                          float* accu) {
  float wf[16], uf[16];
  int8x16_to_float(wv, wf);
  if (UP) int8x16_to_float(uv, uf);
#pragma unroll
  for (int b = 0; b < MAXB; ++b) {
    if (b < B) {
      const uint4* xp = reinterpret_cast<const uint4*>(xk + (size_t)b * K);
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
      float a = acc[b];
#pragma unroll
      for (int j = 0; j < 16; ++j) a = fmaf(xf[j], wf[j], a);
      acc[b] = a;
      if (UP) {
        float u = accu[b];
#pragma unroll
        for (int j = 0; j < 16; ++j) u = fmaf(xf[j], uf[j], u);
        accu[b] = u;
      }
    }
  }
}

// Partial sums of the owned rows: part[(j * S + sg) * 2 * MAXB + b] (and
// + MAXB for the up row) = segment sg of row r0 + j against xs (B, K) bf16.
// Weights come from the slot in shared memory.  Returns S; ends with the
// block synchronised.
template <int MAXB>
__device__ int gemv_partials(const Span& sp, const unsigned char* slot,
                             const __nv_bfloat16* xs, int B, float* part) {
  const int K = sp.K, nr = sp.r1 - sp.r0;
  const int S = seg_count(sp.N, K);
  const int seg = K / S, nch = seg / 16;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int8_t* wrows = reinterpret_cast<const int8_t*>(slot);
  const int8_t* urows = wrows + (size_t)nr * K;
  const bool up = sp.wu != nullptr;
  const int4 zero = make_int4(0, 0, 0, 0);
  for (int t = warp; t < nr * S; t += kWarps) {
    const int j = t / S, sg = t - j * S;
    const int4* wr = reinterpret_cast<const int4*>(wrows + (size_t)j * K + (size_t)sg * seg);
    const int4* ur = reinterpret_cast<const int4*>(urows + (size_t)j * K + (size_t)sg * seg);
    const __nv_bfloat16* xb = xs + (size_t)sg * seg;
    float acc[MAXB], accu[MAXB];
#pragma unroll
    for (int b = 0; b < MAXB; ++b) acc[b] = accu[b] = 0.f;
    if (up) {
      for (int c = lane; c < nch; c += 32)
        fma_chunk<MAXB, true>(wr[c], ur[c], xb + c * 16, K, B, acc, accu);
    } else {
      for (int c = lane; c < nch; c += 32)
        fma_chunk<MAXB, false>(wr[c], zero, xb + c * 16, K, B, acc, accu);
    }
#pragma unroll
    for (int b = 0; b < MAXB; ++b) {
      if (b < B) {
        const float s = warp_sum(acc[b]);
        const float u = up ? warp_sum(accu[b]) : 0.f;
        if (lane == 0) {
          part[(size_t)t * 2 * MAXB + b] = s;
          part[(size_t)t * 2 * MAXB + MAXB + b] = u;
        }
      }
    }
  }
  __syncthreads();
  return S;
}

// Row r0 + j of stream b from the partials, scaled: (down, up).
template <int MAXB>
__device__ __forceinline__ float2 row_value(const Span& sp, const unsigned char* slot,
                                            const float* part, int S, int j, int b) {
  float s = 0.f, u = 0.f;
  for (int sg = 0; sg < S; ++sg) {
    s += part[(size_t)(j * S + sg) * 2 * MAXB + b];
    u += part[(size_t)(j * S + sg) * 2 * MAXB + MAXB + b];
  }
  return make_float2(s * slot_scales(sp, slot)[j],
                     sp.wu != nullptr ? u * slot_scales(sp, slot, true)[j] : 0.f);
}

// out[b * ld + r0 + j] = row r0 + j of stream b, or silu(W_1 row) * (W_3
// row) for the SwiGLU pair.
template <int MAXB>
__device__ __forceinline__ void store_rows(const Span& sp, const unsigned char* slot,
                                           const float* part, int S, int B, float* out, int ld) {
  for (int i = threadIdx.x; i < (sp.r1 - sp.r0) * B; i += kThreads) {
    const int j = i / B, b = i - j * B;
    const float2 v = row_value<MAXB>(sp, slot, part, S, j, b);
    __stcg(out + (size_t)b * ld + sp.r0 + j,
           sp.wu != nullptr ? (v.x * sigmoidf(v.x)) * v.y : v.x);
  }
}

// The s8 GEMV (the Pallas kernel's "s8" dequant mode) on the int8 tensor
// cores.  The input rows are staged as int8, row b at xq + b * s8_ld(K), with
// one f32 scale per stream row; the products are mma.sync m16n8k32 s8 x s8
// -> s32: A (16 x 32) the streams' staged rows, B (32 x 8) eight owned
// weight rows as the bulk copy left them, K-contiguous, which is the .col
// operand.  Integer sums are exact in any order, so only the quantization
// step can differ from the plain version.  wgmma does not fit: its 64-row M
// is more than the B <= 16 streams and the 8-32 rows a block owns.
// Each row's scale comes from its absmax: from a pass over the staged row
// (row_scales_s8), from the maxima the writing phase published
// (fold_scales_s8), or from maxima taken where the row is computed.

// Staging stride of K-wide int8 rows: 64 bytes past a multiple of 128, so
// that the 16-byte loads of two rows by one quarter-warp hit distinct banks.
__host__ __device__ inline int s8_ld(int K) { return (K + 127) / 128 * 128 + 64; }

// 1 / sc within an ulp: the approximate reciprocal and one Newton step.
__device__ __forceinline__ float s8_rcp(float sc) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(sc));
  return __fmaf_rn(r, __fmaf_rn(-sc, r, 1.0f), r);
}

// Row b's scale xsc[b] = max(amax, 1e-30) / 127 (an IEEE quotient, as the
// plain version's) and its reciprocal xrc[b].
__device__ __forceinline__ void set_scale_s8(int b, float amax, float* xsc, float* xrc) {
  const float sc = __fdiv_rn(fmaxf(amax, 1e-30f), 127.0f);
  xsc[b] = sc;
  xrc[b] = s8_rcp(sc);
}

// max(m, |v.x|, ..., |v.w|); fmaxf drops a NaN operand.
__device__ __forceinline__ float abs_max4(float m, const float4& v) {
  return fmaxf(fmaxf(m, fmaxf(fabsf(v.x), fabsf(v.y))), fmaxf(fabsf(v.z), fabsf(v.w)));
}

// The max over a warp of non-negative floats (their bits order as unsigned).
__device__ __forceinline__ float warp_max_pos(float m) {
  return __uint_as_float(__reduce_max_sync(0xffffffffu, __float_as_uint(m)));
}

// The scales of rows whose values get4(b, k4) (n4 float4s a row) lie in
// shared memory: warp w takes rows w, w + kWarps, ...  Every block that
// stages the row gets the same scale: a max is exact in any order.  Ends
// with the block synchronised.
template <typename F>
__device__ void row_scales_s8(F get4, int B, int n4, float* xsc, float* xrc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int b = warp; b < B; b += kWarps) {
    float m = 0.f;
#pragma unroll 4
    for (int k4 = lane; k4 < n4; k4 += 32) m = abs_max4(m, get4(b, k4));
    m = warp_max_pos(m);
    if (lane == 0) set_scale_s8(b, m, xsc, xrc);
  }
  __syncthreads();
}

// The scales of rows whose writers each published the max |value| of the
// elements of row b they wrote, pub[blk * B + b] over the grid: the same as
// row_scales_s8 over the whole row.  Warp w folds rows w, w + kWarps, ...
// Ends with the block synchronised.
__device__ void fold_scales_s8(const float* pub, int B, float* xsc, float* xrc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int b = warp; b < B; b += kWarps) {
    float m = 0.f;
#pragma unroll 4
    for (int blk = lane; blk < (int)gridDim.x; blk += 32)
      m = fmaxf(m, __ldcg(pub + (size_t)blk * B + b));
    m = warp_max_pos(m);
    if (lane == 0) set_scale_s8(b, m, xsc, xrc);
  }
  __syncthreads();
}

// round_half_even(x / sc) for |x / sc| <= 127, the quotient rounded to
// float first as the plain version's, without a division: the bits of the
// integer n + 1.5 * 2^23, whose low byte is n as int8.
//   q = x * r with r within an ulp of 1 / sc is within 2.3e-5 of the
// rounded quotient Q.  Away from a half-integer (by more than 2^-14) q and
// Q round to the same integer, which adding 1.5 * 2^23 gives (the add
// rounds to the nearest integer, ties to even): s8_fast, which also says
// whether q is near one.  Near a half-integer h (once in some eight
// thousand values) s8_near decides the tie exactly: d = x - h sc is exact
// there (both terms are multiples of half sc's last place and d has at
// most 12 bits), Q == h iff x / sc lies within half an ulp of h, which
// compares d scaled by a power of two with sc, and otherwise Q lies on d's
// side.  (Below h = 0.5, the one power of two, the band is a quarter ulp,
// but there Q == h and Q < h both round to 0.)
constexpr float kS8Round = 12582912.0f;         // 1.5 * 2^23
constexpr float kS8Near = 0.5f - 6.103515625e-05f;  // 0.5 - 2^-14
__device__ __forceinline__ unsigned s8_fast(float x, float r, bool& near) {
  const float q = __fmul_rn(x, r);
  const float t = __fadd_rn(q, kS8Round);
  near |= fabsf(__fsub_rn(q, __fsub_rn(t, kS8Round))) >= kS8Near;
  return __float_as_uint(t);
}
__device__ __forceinline__ unsigned s8_near(float x, float sc, float r) {
  const float q = __fmul_rn(x, r);
  const float n0 = __fsub_rn(__fadd_rn(q, kS8Round), kS8Round);
  float n = n0;
  if (fabsf(__fsub_rn(q, n0)) >= kS8Near) {
    const float h = __fadd_rn(n0, copysignf(0.5f, __fsub_rn(q, n0)));
    const float d = __fmaf_rn(-h, sc, x);
    const int k = ((__float_as_uint(h) >> 23) & 0xff) - 127;  // 2^k <= |h| < 2^(k + 1)
    const float s = __fmul_rn(d, copysignf(__uint_as_float((unsigned)(151 - k) << 23), h));
    if (s <= sc && s >= -sc)  // Q == h
      n = __fsub_rn(__fadd_rn(h, kS8Round), kS8Round);
    else
      n = d > 0.f ? __fadd_rn(h, 0.5f) : __fsub_rn(h, 0.5f);
  }
  return __float_as_uint(__fadd_rn(n, kS8Round));
}

// The four values of v quantized by (sc, r), one int8 a byte: s8_fast for
// all four, and s8_near for all four in the rare case that one is near a
// tie (a branch, so the common case does not pay for it).
__device__ __forceinline__ unsigned s8_quantize4(const float4& v, float sc, float r) {
  bool near = false;
  unsigned a = s8_fast(v.x, r, near), b = s8_fast(v.y, r, near);
  unsigned c = s8_fast(v.z, r, near), d = s8_fast(v.w, r, near);
  if (__builtin_expect(near, 0)) {
    a = s8_near(v.x, sc, r);
    b = s8_near(v.y, sc, r);
    c = s8_near(v.z, sc, r);
    d = s8_near(v.w, sc, r);
  }
  return __byte_perm(__byte_perm(a, b, 0x0040u), __byte_perm(c, d, 0x0040u), 0x5410u);
}

// A thread's float4s of B rows of n4 float4s each, in order and kThreads
// apart: (b, k4), stepped without a division.
struct RowWalk {
  int b, k4, n4, db, dk;
  __device__ explicit RowWalk(int n4_) : n4(n4_) {
    db = kThreads / n4;
    dk = kThreads - db * n4;
    b = threadIdx.x / n4;
    k4 = threadIdx.x - b * n4;
  }
  __device__ void next() {
    b += db;
    k4 += dk;
    if (k4 >= n4) {
      k4 -= n4;
      ++b;
    }
  }
};

// xq[b * ld + 4 k4 + i] = round_half_even(get4(b, k4)[i] / xsc[b]) for
// b < B, k4 < n4, with get4 reading shared memory.  Ends with the block
// synchronised.
template <typename F>
__device__ void quantize_rows_s8(F get4, int B, int n4, const float* xsc, const float* xrc,
                                 int8_t* xq, int ld) {
  for (RowWalk w(n4); w.b < B; w.next())
    *reinterpret_cast<unsigned*>(xq + (size_t)w.b * ld + 4 * w.k4) =
        s8_quantize4(get4(w.b, w.k4), xsc[w.b], xrc[w.b]);
  __syncthreads();
}

// The same for rows in global memory written by other blocks (src, row
// stride 4 n4 floats), read once from L2, their scales folded from the
// maxima the writers published (pub, fold_scales_s8) while the first reads
// are in flight: each thread keeps kS8Ring 16-byte copies in flight
// (cp.async.cg, L2 only) into its own slots of ring (kS8Ring x kThreads
// float4s of shared memory), so the reads wait in shared memory, not in
// registers.  Ends with the block synchronised.
constexpr int kS8Ring = 4;
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ void quantize_l2_rows_s8(const float* src, const float* pub, int B, int n4,
                                    float* xsc, float* xrc, int8_t* xq, int ld, float4* ring) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  RowWalk in(n4), out(n4);
#pragma unroll
  for (int s = 0; s < kS8Ring; ++s) {
    if (in.b < B) cp_async16(ring + s * kThreads + threadIdx.x, s4 + (size_t)in.b * n4 + in.k4);
    asm volatile("cp.async.commit_group;" ::: "memory");
    in.next();
  }
  fold_scales_s8(pub, B, xsc, xrc);
  for (int s = 0; out.b < B; s = s + 1 < kS8Ring ? s + 1 : 0) {
    asm volatile("cp.async.wait_group %0;" ::"n"(kS8Ring - 1) : "memory");
    float4* slot = ring + s * kThreads + threadIdx.x;
    *reinterpret_cast<unsigned*>(xq + (size_t)out.b * ld + 4 * out.k4) =
        s8_quantize4(*slot, xsc[out.b], xrc[out.b]);
    out.next();
    if (in.b < B) cp_async16(slot, s4 + (size_t)in.b * n4 + in.k4);
    asm volatile("cp.async.commit_group;" ::: "memory");
    in.next();
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
}

// d += A B for one m16n8k32 tile: a0..a3 the A fragment (rows g, g + 8,
// g, g + 8 of the lane's group g), b0, b1 the B fragment (column g).
__device__ __forceinline__ void mma_s8(int* d, unsigned a0, unsigned a1, unsigned a2,
                                       unsigned a3, unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The owned rows in n8 tiles: each matrix's nr rows make (nr + 7) / 8 tiles,
// the SwiGLU up matrix's after W_1's, T in all (0 for a block that owns no
// rows); each tile's K is split over S warps (a power of two, T * S <=
// kWarps when T < kWarps).
__device__ __forceinline__ int s8_tiles(const Span& sp) { return (sp.r1 - sp.r0 + 7) / 8; }
__device__ __forceinline__ int s8_splits(int T) {
  int S = 1;
  while (S < kWarps && T * S * 2 <= kWarps) S *= 2;
  return S;
}

// The s32 partials of the owned rows: task = tile * S + sg, the sum of
// split sg of the tile's K for stream b and the tile's column c at
// part[(task * MAXB + b) * 8 + c].  Warp w takes tasks w, w + kWarps, ...
// and walks its split in 64-byte chunks: lane (g, t) = (lane / 4, lane % 4)
// loads the 16 bytes at 16 t of the chunk of weight row 8 tile + g and of
// stream rows g and g + 8, and feeds bytes 0-7 as the first k-step's
// fragments and bytes 8-15 as the second's.  That permutes k the same way
// in A and in B, which leaves every sum as it is.  Weight rows past nr in
// the last tile read the slot's next bytes (the launch pads the slot to
// whole tiles) and make columns that are never read; chunks past K read
// zeros.  Returns S; ends with the block synchronised.
template <int MAXB>
__device__ int gemv_partials_s8(const Span& sp, const unsigned char* slot, const int8_t* xq,
                                int B, int* part) {
  const int K = sp.K, nr = sp.r1 - sp.r0, ld = s8_ld(K);
  const int nt = s8_tiles(sp), T = (sp.wu != nullptr ? 2 : 1) * nt;
  const int S = s8_splits(T), nc = (K + 63) / 64;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int8_t* wrows = reinterpret_cast<const int8_t*>(slot);
  const int4 zero = make_int4(0, 0, 0, 0);
  for (int task = warp; task < T * S; task += kWarps) {
    const int tile = task / S, sg = task - tile * S;
    const int row = tile < nt ? tile * 8 + g : nr + (tile - nt) * 8 + g;
    const int8_t* wr = wrows + (size_t)row * K;
    int d[4] = {0, 0, 0, 0};
#pragma unroll 1
    for (int c = sg * nc / S; c < (sg + 1) * nc / S; ++c) {
      const int k = c * 64 + 16 * t;
      int4 w = zero, lo = zero, hi = zero;
      if (k < K) {
        w = *reinterpret_cast<const int4*>(wr + k);
        if (g < B) lo = *reinterpret_cast<const int4*>(xq + (size_t)g * ld + k);
        if (MAXB > 8 && g + 8 < B)
          hi = *reinterpret_cast<const int4*>(xq + (size_t)(g + 8) * ld + k);
      }
      mma_s8(d, lo.x, hi.x, lo.y, hi.y, w.x, w.y);
      mma_s8(d, lo.z, hi.z, lo.w, hi.w, w.z, w.w);
    }
    // D: lane (g, t) holds rows g and g + 8, columns 2 t and 2 t + 1
    int* out = part + (size_t)task * MAXB * 8;
    if (g < B) *reinterpret_cast<int2*>(out + g * 8 + 2 * t) = make_int2(d[0], d[1]);
    if (MAXB > 8 && g + 8 < B)
      *reinterpret_cast<int2*>(out + (g + 8) * 8 + 2 * t) = make_int2(d[2], d[3]);
  }
  __syncthreads();
  return S;
}

// Row r0 + j of stream b from the s32 partials, its splits summed in order:
// ((float)sum * xsc_b) * s_j, the plain version's order, for (down, up).
template <int MAXB>
__device__ __forceinline__ float2 row_value_s8(const Span& sp, const unsigned char* slot,
                                               const int* part, int S, int j, int b,
                                               float xsc_b) {
  const size_t split = (size_t)MAXB * 8;
  const int* pd = part + ((size_t)(j >> 3) * S * MAXB + b) * 8 + (j & 7);
  const int* pu = pd + (size_t)s8_tiles(sp) * S * split;
  int s = 0, u = 0;
#pragma unroll 4
  for (int sg = 0; sg < S; ++sg) {
    s += pd[sg * split];
    if (sp.wu != nullptr) u += pu[sg * split];
  }
  return make_float2(
      (__int2float_rn(s) * xsc_b) * slot_scales(sp, slot)[j],
      sp.wu != nullptr ? (__int2float_rn(u) * xsc_b) * slot_scales(sp, slot, true)[j] : 0.f);
}

// store_rows from the s32 partials, stream b's row scaled by xsc[b].  With
// pub, each stream's max |value| over the rows stored goes to
// pub[blockIdx.x * B + b] (taken in pmax, B floats of shared memory), for
// fold_scales_s8, after a block synchronisation.
template <int MAXB>
__device__ void store_rows_s8(const Span& sp, const unsigned char* slot, const int* part, int S,
                              int B, const float* xsc, float* out, int ld,
                              float* pmax = nullptr, float* pub = nullptr) {
  if (pub != nullptr) {
    if ((int)threadIdx.x < B) pmax[threadIdx.x] = 0.f;
    __syncthreads();
  }
  for (int i = threadIdx.x; i < (sp.r1 - sp.r0) * B; i += kThreads) {
    const int j = i / B, b = i - j * B;
    const float2 v = row_value_s8<MAXB>(sp, slot, part, S, j, b, xsc[b]);
    const float y = sp.wu != nullptr ? (v.x * sigmoidf(v.x)) * v.y : v.x;
    __stcg(out + (size_t)b * ld + sp.r0 + j, y);
    if (pub != nullptr)  // non-negative floats order as their bits
      atomicMax(reinterpret_cast<int*>(pmax) + b, __float_as_int(fmaxf(0.f, fabsf(y))));
  }
  if (pub != nullptr) {
    __syncthreads();
    if ((int)threadIdx.x < B) __stcg(pub + (size_t)blockIdx.x * B + threadIdx.x, pmax[threadIdx.x]);
  }
}

// rstd[b] = 1 / sqrt(sum_k v[b, k]^2 / n + eps): warp w sums its share of
// row b, lanes strided by the block; then warp b folds the 16 shares with a
// fixed butterfly, so every block gets the same bits.
__device__ void rms_scales(const float* v, int B, int n, float eps, float* red, float* rstd) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int b = 0; b < B; ++b) {
    float acc = 0.f;
#pragma unroll 4
    for (int k = warp * 32 + lane; k < n; k += kThreads) {
      const float t = v[(size_t)b * n + k];
      acc += t * t;
    }
    acc = warp_sum(acc);
    if (lane == 0) red[b * kWarps + warp] = acc;
  }
  __syncthreads();
  for (int b = warp; b < B; b += kWarps) {
    float acc = lane < kWarps ? red[b * kWarps + lane] : 0.f;
#pragma unroll
    for (int o = kWarps / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) rstd[b] = 1.0f / sqrtf(acc / (float)n + eps);
  }
  __syncthreads();
}

// Thread 0 records the global timer in the block's next clock slot.
__device__ __forceinline__ void stamp(unsigned long long* clock, int clock_cap, int& n) {
  if (threadIdx.x == 0 && n < clock_cap) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    clock[(size_t)blockIdx.x * clock_cap + n] = t;
  }
  ++n;
}

}  // namespace
}  // namespace fts
