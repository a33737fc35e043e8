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
// - row_scales_s8(), quantize_rows_s8(), gemv_partials_s8(),
//   row_value_s8(), store_rows_s8(): the same GEMV against an int8 staging
//   of the input (per-row absmax scale), by __dp4a into s32.
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

// The s8 GEMV (the Pallas kernel's "s8" dequant mode): the input row is
// staged as int8 with one f32 scale per stream row, and each 16-byte weight
// chunk meets the same 16 input bytes in four __dp4a, summed in s32.
// Integer sums are exact in any order, so only the quantization step can
// differ from the plain version.

// xsc[b] = max(max_k |get(b, k)|, 1e-30) / 127 over k < n.  Every block that
// stages the row gets the same scale: a max is exact in any order.  Uses
// red (B x kWarps floats); ends with the block synchronised.
template <typename F>
__device__ void row_scales_s8(F get, int B, int n, float* red, float* xsc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int b = 0; b < B; ++b) {
    float m = 0.f;
    for (int k = threadIdx.x; k < n; k += kThreads) m = fmaxf(m, fabsf(get(b, k)));
    m = warp_max(m);
    if (lane == 0) red[b * kWarps + warp] = m;
  }
  __syncthreads();
  for (int b = warp; b < B; b += kWarps) {
    const float m = warp_max(lane < kWarps ? red[b * kWarps + lane] : 0.f);
    if (lane == 0) xsc[b] = __fdiv_rn(fmaxf(m, 1e-30f), 127.0f);
  }
  __syncthreads();
}

// xq[b * n + k] = round_half_even(get(b, k) / xsc[b]) as int8, with an IEEE
// division (|xq| <= 127 by construction); ends with the block synchronised.
template <typename F>
__device__ void quantize_rows_s8(F get, int B, int n, const float* xsc, int8_t* xq) {
  for (int i = threadIdx.x; i < B * n; i += kThreads) {
    const int b = i / n;
    xq[i] = (int8_t)__float2int_rn(__fdiv_rn(get(b, i - b * n), xsc[b]));
  }
  __syncthreads();
}

// acc[b] += sum_j x[b, k0 + j] * w[j] over one 16-byte chunk of a row (and
// the same for the SwiGLU up row), in s32; xk points at x[0, k0].
template <int MAXB, bool UP>
__device__ __forceinline__ void dp4a_chunk(const int4& wv, const int4& uv, const int8_t* xk,
                                           int K, int B, int* acc, int* accu) {
#pragma unroll
  for (int b = 0; b < MAXB; ++b) {
    if (b < B) {
      const int4 xv = *reinterpret_cast<const int4*>(xk + (size_t)b * K);
      int s = acc[b];
      s = __dp4a(wv.x, xv.x, s);
      s = __dp4a(wv.y, xv.y, s);
      s = __dp4a(wv.z, xv.z, s);
      s = __dp4a(wv.w, xv.w, s);
      acc[b] = s;
      if (UP) {
        int u = accu[b];
        u = __dp4a(uv.x, xv.x, u);
        u = __dp4a(uv.y, xv.y, u);
        u = __dp4a(uv.z, xv.z, u);
        u = __dp4a(uv.w, xv.w, u);
        accu[b] = u;
      }
    }
  }
}

// gemv_partials with an int8 staging xq (B, K): part[(j * S + sg) * 2 *
// MAXB + b] (and + MAXB for the up row) is the s32 sum of segment sg of row
// r0 + j.  Returns S; ends with the block synchronised.
template <int MAXB>
__device__ int gemv_partials_s8(const Span& sp, const unsigned char* slot, const int8_t* xq,
                                int B, int* part) {
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
    const int8_t* xb = xq + (size_t)sg * seg;
    int acc[MAXB], accu[MAXB];
#pragma unroll
    for (int b = 0; b < MAXB; ++b) acc[b] = accu[b] = 0;
    if (up) {
      for (int c = lane; c < nch; c += 32)
        dp4a_chunk<MAXB, true>(wr[c], ur[c], xb + c * 16, K, B, acc, accu);
    } else {
      for (int c = lane; c < nch; c += 32)
        dp4a_chunk<MAXB, false>(wr[c], zero, xb + c * 16, K, B, acc, accu);
    }
#pragma unroll
    for (int b = 0; b < MAXB; ++b) {
      if (b < B) {
        const int s = __reduce_add_sync(0xffffffffu, acc[b]);
        const int u = up ? __reduce_add_sync(0xffffffffu, accu[b]) : 0;
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

// Row r0 + j of stream b from the s32 partials: ((float)sum * xsc_b) * s_j,
// the plain version's order, for (down, up).
template <int MAXB>
__device__ __forceinline__ float2 row_value_s8(const Span& sp, const unsigned char* slot,
                                               const int* part, int S, int j, int b,
                                               float xsc_b) {
  int s = 0, u = 0;
  for (int sg = 0; sg < S; ++sg) {
    s += part[(size_t)(j * S + sg) * 2 * MAXB + b];
    u += part[(size_t)(j * S + sg) * 2 * MAXB + MAXB + b];
  }
  return make_float2(
      (__int2float_rn(s) * xsc_b) * slot_scales(sp, slot)[j],
      sp.wu != nullptr ? (__int2float_rn(u) * xsc_b) * slot_scales(sp, slot, true)[j] : 0.f);
}

// store_rows from the s32 partials, stream b's row scaled by xsc[b].
template <int MAXB>
__device__ __forceinline__ void store_rows_s8(const Span& sp, const unsigned char* slot,
                                              const int* part, int S, int B, const float* xsc,
                                              float* out, int ld) {
  for (int i = threadIdx.x; i < (sp.r1 - sp.r0) * B; i += kThreads) {
    const int j = i / B, b = i - j * B;
    const float2 v = row_value_s8<MAXB>(sp, slot, part, S, j, b, xsc[b]);
    __stcg(out + (size_t)b * ld + sp.r0 + j,
           sp.wu != nullptr ? (v.x * sigmoidf(v.x)) * v.y : v.x);
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
