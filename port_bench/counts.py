"""Operations and bytes of the decode kernels and of a frame, from shapes.

The arithmetic of the port's kernel bounds: each input read once and each
output written once, over the card's memory rate, or the operations over
the peak rate of their type, whichever is larger.  ``m`` is a configuration
file's ``model`` sizes, ``v`` its ``codec`` sizes.  The peaks are one
NVIDIA H100 SXM's data sheet (dense).

By hand at S1-mini's sizes (dim 1024, 16 heads and 8 KV heads of 64, FFN
4096, 28 + 4 layers, vocabulary 155 776, 10 books of 4096 / 1024 codes):
an int8 slow layer is 2048x1024 + 1024x1024 + 2 x 4096x1024 + 1024x4096 =
15 728 640 bytes (15.7 MB); the tied head 155 776 x 1024 = 159 514 624
(159.5 M); the four fast layers 62 914 560 bytes (62.9 MB).  One frame of
the LM is 2 x (28 x 15.73 M + 159.5 M) = 1.20 GFLOP in the slow stack
(plus attention, 4 x 28 x rows x 1024), and 2 x (10 x 4 x 15.73 M +
9 x 1024 x 1024) = 1.28 GFLOP in the fast stack: about 2.5 GFLOP.  The
codec's decode of one frame is about 6.8 GFLOP (``codec_flops_per_frame``),
most of it in the decoder's residual units.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12


def bound_s(nbytes: float, ops: float, ops_rate: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / ops_rate)


def layer_weights(dim: int, heads: int, kv_heads: int, head_dim: int, ffn: int) -> int:
    """Elements of one layer's five matrices."""
    return ((heads + 2 * kv_heads) * head_dim * dim + dim * heads * head_dim
            + 3 * ffn * dim)


def slow_layer(m: dict) -> int:
    return layer_weights(m["dim"], m["n_head"], m["n_local_heads"], m["head_dim"],
                         m["intermediate_size"])


def fast_layer(m: dict) -> int:
    return layer_weights(m["fast_dim"], m["fast_n_head"], m["fast_n_local_heads"],
                         m["fast_head_dim"], m["fast_intermediate_size"])


def _scale_rows(dim, heads, kv_heads, head_dim, ffn) -> int:
    """Output rows of one layer's five matrices: one f32 scale each."""
    return (heads + 2 * kv_heads) * head_dim + 2 * dim + 2 * ffn


def slow_stack_call(m: dict, batch: int, rows: int) -> float:
    """Seconds of the bound of one int8 slow-stack call with its tied head,
    ``rows`` the cache rows its streams read, summed."""
    L, D, V = m["n_layer"], m["dim"], m["vocab_size"]
    Hkv, Dh = m["n_local_heads"], m["head_dim"]
    n_w = L * slow_layer(m)
    scales = 4 * L * _scale_rows(D, m["n_head"], Hkv, Dh, m["intermediate_size"])
    read = (4 * batch * D + 4 * batch + n_w + scales + 2 * 2 * L * D
            + 2 * D + V * D + 4 * V + rows * L * 2 * Hkv * Dh * 2)
    written = 4 * (batch * D + 2 * L * batch * Hkv * Dh + batch * V)
    ops = 2 * batch * (n_w + V * D) + 4 * L * rows * m["n_head"] * Dh
    return bound_s(read + written, ops, BF16_OPS_PER_S)


def fast_decoder_call(m: dict, batch: int, window: int) -> float:
    """Seconds of the bound of one int8 fast-decoder call (every book of
    one frame for ``batch`` streams)."""
    L, Df, K, Vr = m["n_fast_layer"], m["fast_dim"], m["num_codebooks"], m["residual_codebook_size"]
    n_w = L * fast_layer(m)
    scales = 4 * L * _scale_rows(Df, m["fast_n_head"], m["fast_n_local_heads"],
                                 m["fast_head_dim"], m["fast_intermediate_size"])
    read = (2 * batch * Df + 4 * batch + 4 * batch * (K - 1) * window
            + 4 * batch * (K - 1) * Vr + 3 * 4 * batch + n_w + scales + 2 * 2 * L * Df
            + 2 * Df + Vr * Df + 4 * Vr + batch * (K - 1) * (Df + 4))
    written = 4 * batch * (K - 1) + 4 * batch * (K - 1) * Vr
    ops = 2 * batch * K * n_w + 2 * batch * (K - 1) * Vr * Df + 2 * batch * (K - 1) * Vr * Vr
    return bound_s(read + written, ops, BF16_OPS_PER_S)


def sampler_call(m: dict, batch: int) -> float:
    """Seconds of the bound of one slow-token sampler call: logits and
    noise read once with the penalty column, the ids written."""
    V, W = m["vocab_size"], 1 + m["num_codebooks"]
    nbytes = 4 * batch * V * 2 + 4 * batch * W + 3 * 4 * batch + 4 * batch
    return bound_s(nbytes, batch * V * (W + 5), F32_OPS_PER_S)


def lm_flops_per_frame(m: dict, rows: float) -> float:
    """Model FLOPs of one frame of one stream whose cache holds ``rows``."""
    slow = 2 * (m["n_layer"] * slow_layer(m) + m["vocab_size"] * m["dim"])
    attn = 4 * m["n_layer"] * rows * m["n_head"] * m["head_dim"]
    K = m["num_codebooks"]
    fast = (2 * K * m["n_fast_layer"] * fast_layer(m)
            + 2 * (K - 1) * m["residual_codebook_size"] * m["fast_dim"]
            + 4 * m["n_fast_layer"] * m["fast_n_head"] * m["fast_head_dim"] * K * (K + 1) // 2)
    return slow + attn + fast


def codec_flops_per_frame(v: dict) -> float:
    """Model FLOPs of the codec's decode of one frame: the books'
    projections, the window transformer, the upsampling stages and the
    decoder's convolutions."""
    t = v["quantizer_transformer"]
    C, K = v["quantizer_input_dim"], 1 + v["n_residual_codebooks"]
    D, I = t["dim"], t["intermediate_size"]
    macs = K * v["codebook_dim"] * C
    macs += t["n_layer"] * (3 * D * D + D * D + 3 * D * I
                            + 2 * v["quantizer_window"] * t["n_head"] * t["head_dim"])
    pos = 1
    for f in reversed(v["downsample_factor"]):
        pos *= f
        macs += pos * (C * C + 7 * C + 8 * C * C)  # transposed conv, ConvNeXt
    ch = v["decoder_dim"]
    macs += pos * 7 * v["latent_dim"] * ch
    for i, s in enumerate(v["decoder_rates"]):
        d_in, d_out = ch // 2 ** i, ch // 2 ** (i + 1)
        pos *= s
        macs += pos * (2 * d_in * d_out + 3 * (7 * d_out * d_out + d_out * d_out))
    macs += pos * 7 * (ch // 2 ** len(v["decoder_rates"]))
    return 2.0 * macs
