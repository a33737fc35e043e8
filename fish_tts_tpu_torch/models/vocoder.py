"""DAC-style codec (port of ``fish_tts_tpu/models/vocoder.py``).

Audio (B, 1, T) -> codes (B, 1+R, ceil(T / frame_length)), ``dac_encode``:

  encoder: stem conv -> 4x (3 dilated ResidualUnits + Snake + strided conv
    [+ window-512 transformer at the last stage]) -> Snake -> conv
  quantizer encode: 2x (causal strided conv + ConvNeXt) -> pre window-128
    transformer -> the semantic codebook's nearest entry, then each
    residual codebook's on what is left

Codes (B, 1+R, N) -> audio (B, 1, N * frame_length), ``dac_decode``:

  quantizer decode: semantic + residual codebook embeddings, summed ->
    post window-128 transformer -> 2x (causal transposed conv + ConvNeXt)
  decoder: stem conv -> 4x (Snake + transposed conv + 3 ResidualUnits)
    -> Snake -> conv -> tanh

The parameter tree and its layouts are the JAX package's (conv kernels
``(O, I/groups, K)``, transposed ``(I, O, K)``, linear weights
``(in, out)``).  The decoder-side transformers of the config are dropped,
as in the JAX package.  The JAX package runs all of this on XLA
convolutions and einsums, outside any Pallas kernel; here they are
``F.conv1d`` and matrix products.
"""

from __future__ import annotations

import functools
from typing import Any

import torch
import torch.nn.functional as F

from fish_tts_tpu_torch.config import VocoderConfig, VocoderTransformerConfig
from fish_tts_tpu_torch.ops.attention import attention, window_causal_bias
from fish_tts_tpu_torch.ops.conv import causal_conv1d, causal_conv_transpose1d
from fish_tts_tpu_torch.ops.norms import layer_norm, silu, snake, vocoder_rms_norm
from fish_tts_tpu_torch.ops.rope import apply_rotary_emb, precompute_freqs_cis

Params = dict[str, Any]


# ---------------------------------------------------------------------------
# Initializers (random)
# ---------------------------------------------------------------------------


def _trunc(gen, shape, dtype, std=0.02):
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * std).to(dtype)


def _zeros(gen, shape, dtype):
    return torch.zeros(shape, dtype=dtype, device=gen.device)


def _conv_p(gen, c_out, c_in, k, dtype, groups=1):
    return {"w": _trunc(gen, (c_out, c_in // groups, k), dtype),
            "b": _zeros(gen, (c_out,), dtype)}


def _tconv_p(gen, c_in, c_out, k, dtype):
    return {"w": _trunc(gen, (c_in, c_out, k), dtype), "b": _zeros(gen, (c_out,), dtype)}


def _linear_p(gen, d_in, d_out, dtype):
    return {"w": _trunc(gen, (d_in, d_out), dtype), "b": _zeros(gen, (d_out,), dtype)}


def _snake_p(gen, dim, dtype):
    return torch.ones((1, dim, 1), dtype=dtype, device=gen.device)


def _residual_unit_p(gen, dim, dtype):
    return {"snake1": _snake_p(gen, dim, dtype), "conv1": _conv_p(gen, dim, dim, 7, dtype),
            "snake2": _snake_p(gen, dim, dtype), "conv2": _conv_p(gen, dim, dim, 1, dtype)}


def _wlt_p(gen, tcfg: VocoderTransformerConfig, input_dim: int, dtype):
    L, D, I = tcfg.n_layer, tcfg.dim, tcfg.intermediate_size
    qkv_out = (tcfg.n_head + 2 * tcfg.n_local_heads) * tcfg.head_dim
    ones = lambda: torch.ones((L, D), dtype=dtype, device=gen.device)  # noqa: E731
    p: Params = {
        "layers": {
            "wqkv": _trunc(gen, (L, D, qkv_out), dtype),
            "wo": _trunc(gen, (L, tcfg.n_head * tcfg.head_dim, D), dtype),
            "w1": _trunc(gen, (L, D, I), dtype),
            "w3": _trunc(gen, (L, D, I), dtype),
            "w2": _trunc(gen, (L, I, D), dtype),
            "attention_norm": ones(),
            "ffn_norm": ones(),
            "attn_scale": ones() * 1e-2,
            "ffn_scale": ones() * 1e-2,
        },
        "norm": torch.ones((D,), dtype=dtype, device=gen.device),
    }
    if input_dim != tcfg.dim:
        p["input_proj"] = _linear_p(gen, input_dim, D, dtype)
        p["output_proj"] = _linear_p(gen, D, input_dim, dtype)
    if tcfg.pos_embed_type == "conformer":
        p["layers"]["rel_pos_embeddings"] = _trunc(
            gen, (L, 2 * tcfg.max_relative_position + 1, tcfg.head_dim), dtype)
    return p


def _convnext_p(gen, dim, dtype, mlp_ratio=4.0):
    hidden = int(mlp_ratio * dim)
    return {
        "dwconv": _conv_p(gen, dim, dim, 7, dtype, groups=dim),
        "norm_w": torch.ones((dim,), dtype=dtype, device=gen.device),
        "norm_b": _zeros(gen, (dim,), dtype),
        "pw1": _linear_p(gen, dim, hidden, dtype),
        "pw2": _linear_p(gen, hidden, dim, dtype),
        "gamma": torch.full((dim,), 1e-6, dtype=dtype, device=gen.device),
    }


def _vq_p(gen, input_dim, codebook_size, codebook_dim, dtype):
    return {
        "in_proj": _conv_p(gen, codebook_dim, input_dim, 1, dtype),
        "out_proj": _conv_p(gen, input_dim, codebook_dim, 1, dtype),
        "codebook": torch.randn((codebook_size, codebook_dim), generator=gen,
                                device=gen.device).to(dtype),
    }


def _stage_tcfg(d: int, n_t: int) -> VocoderTransformerConfig:
    """Encoder-stage transformer wiring: heads of 64, 3x FFN."""
    return VocoderTransformerConfig(block_size=16384, n_layer=n_t, n_head=d // 64,
                                    dim=d, intermediate_size=d * 3, head_dim=64)


def init_vocoder_params(gen: torch.Generator, cfg: VocoderConfig,
                        dtype=torch.float32) -> Params:
    """Random codec parameters on the generator's device."""
    tq = cfg.quantizer_transformer
    d = cfg.encoder_dim
    enc: Params = {"stem": _conv_p(gen, d, 1, 7, dtype), "blocks": []}
    for stride, n_t in zip(cfg.encoder_rates, cfg.encoder_transformer_layers):
        d *= 2
        block = {
            "units": [_residual_unit_p(gen, d // 2, dtype) for _ in range(3)],
            "snake": _snake_p(gen, d // 2, dtype),
            "down": _conv_p(gen, d, d // 2, 2 * stride, dtype),
        }
        if n_t > 0:
            block["wlt"] = _wlt_p(gen, _stage_tcfg(d, n_t), d, dtype)
        enc["blocks"].append(block)
    enc["final_snake"] = _snake_p(gen, d, dtype)
    enc["final_conv"] = _conv_p(gen, cfg.latent_dim, d, 3, dtype)

    qd = cfg.quantizer_input_dim
    quant: Params = {
        "downsample": [
            {"conv": _conv_p(gen, qd, qd, f, dtype), "convnext": _convnext_p(gen, qd, dtype)}
            for f in cfg.downsample_factor
        ],
        "pre": _wlt_p(gen, tq, qd, dtype),
        "post": _wlt_p(gen, tq, qd, dtype),
        "semantic": _vq_p(gen, qd, cfg.semantic_codebook_size, cfg.codebook_dim, dtype),
        "residual": [
            _vq_p(gen, qd, cfg.residual_codebook_size, cfg.codebook_dim, dtype)
            for _ in range(cfg.n_residual_codebooks)
        ],
        "upsample": [
            {"tconv": _tconv_p(gen, qd, qd, f, dtype), "convnext": _convnext_p(gen, qd, dtype)}
            for f in reversed(cfg.downsample_factor)
        ],
    }

    ch = cfg.decoder_dim
    dec: Params = {"stem": _conv_p(gen, ch, cfg.latent_dim, 7, dtype), "blocks": []}
    out_dim = ch
    for i, stride in enumerate(cfg.decoder_rates):
        in_dim = ch // (2 ** i)
        out_dim = ch // (2 ** (i + 1))
        dec["blocks"].append({
            "snake": _snake_p(gen, in_dim, dtype),
            "up": _tconv_p(gen, in_dim, out_dim, 2 * stride, dtype),
            "units": [_residual_unit_p(gen, out_dim, dtype) for _ in range(3)],
        })
    dec["final_snake"] = _snake_p(gen, out_dim, dtype)
    dec["final_conv"] = _conv_p(gen, 1, out_dim, 7, dtype)
    return {"encoder": enc, "quantizer": quant, "decoder": dec}


# ---------------------------------------------------------------------------
# Forward pieces
# ---------------------------------------------------------------------------


def _residual_unit(p: Params, x, dilation: int):
    """Snake -> dilated conv7 -> Snake -> conv1, residual."""
    y = snake(x, p["snake1"])
    y = causal_conv1d(y, p["conv1"]["w"], p["conv1"]["b"], dilation=dilation)
    y = snake(y, p["snake2"])
    y = causal_conv1d(y, p["conv2"]["w"], p["conv2"]["b"])
    return x + y


def wlt_layer_body(lp: Params, h, tcfg: VocoderTransformerConfig, freqs, bias,
                   kv_cache=None):
    """One window-limited transformer layer on (B, T, D), with the q/k/v split
    at ``kv_size`` of the fused projection: the one source of the layer for
    the joint forward (:func:`_wlt_forward`) and the streamed one
    (``vocoder_stream.stream_wlt``).  ``freqs`` is (T, Dh/2, 2) or per
    stream (B, T, Dh/2, 2); ``kv_cache`` an optional carried window (k, v)
    (B, Hkv, W, Dh), put before this chunk's keys and values.  Returns
    (h, (k, v)) with the keys and values (B, Hkv, [W +] T, Dh) attended."""
    H, Hkv, Dh = tcfg.n_head, tcfg.n_local_heads, tcfg.head_dim
    kv_size = Hkv * Dh
    B, T = h.shape[0], h.shape[1]
    a_in = vocoder_rms_norm(h, lp["attention_norm"], tcfg.norm_eps)
    qkv = a_in @ lp["wqkv"]
    q, k, v = qkv[..., :kv_size], qkv[..., kv_size:2 * kv_size], qkv[..., 2 * kv_size:]
    q = q.reshape(B, T, H, Dh)
    k = k.reshape(B, T, Hkv, Dh)
    v = v.reshape(B, T, Hkv, Dh)
    if tcfg.pos_embed_type == "rope":
        q = apply_rotary_emb(q, freqs)
        k = apply_rotary_emb(k, freqs)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    if kv_cache is not None:
        k = torch.cat([kv_cache[0], k], dim=2)
        v = torch.cat([kv_cache[1], v], dim=2)
    att = attention(q, k, v, bias)
    att = att.transpose(1, 2).reshape(B, T, H * Dh)
    h = h + (att @ lp["wo"]) * lp["attn_scale"]
    f_in = vocoder_rms_norm(h, lp["ffn_norm"], tcfg.norm_eps)
    f = (silu(f_in @ lp["w1"]) * (f_in @ lp["w3"])) @ lp["w2"]
    return h + f * lp["ffn_scale"], (k, v)


@functools.cache
def rope_table(n: int, head_dim: int, base: float, device: torch.device) -> torch.Tensor:
    """The rotary (cos, sin) table of ``n`` positions on ``device``, made
    once: a table copied from the host at each call would wait for the work
    queued on the device before it.  Its rows do not depend on ``n``."""
    return precompute_freqs_cis(n, head_dim, base, device=device)


def _wlt_forward(p: Params, tcfg: VocoderTransformerConfig, window: int, x):
    """Window-limited transformer on channels-first input (B, C, T)."""
    x = x.transpose(1, 2)
    if "input_proj" in p:
        x = x @ p["input_proj"]["w"] + p["input_proj"]["b"]
    T = x.shape[1]
    pos = torch.arange(T, device=x.device)
    freqs = (rope_table(max(T, tcfg.block_size), tcfg.head_dim, tcfg.rope_base, x.device)[:T]
             if tcfg.pos_embed_type == "rope" else None)
    bias = window_causal_bias(pos, pos, window)
    layers = p["layers"]
    for i in range(layers["wqkv"].shape[0]):
        lp = {k: v[i] for k, v in layers.items()}
        x, _ = wlt_layer_body(lp, x, tcfg, freqs, bias)
    x = vocoder_rms_norm(x, p["norm"], tcfg.norm_eps)
    if "output_proj" in p:
        x = x @ p["output_proj"]["w"] + p["output_proj"]["b"]
    return x.transpose(1, 2)


def _convnext(p: Params, x):
    """ConvNeXt block, channels-first."""
    inp = x
    x = causal_conv1d(x, p["dwconv"]["w"], p["dwconv"]["b"], groups=x.shape[1])
    x = x.transpose(1, 2)
    x = layer_norm(x, p["norm_w"], p["norm_b"], eps=1e-6)
    x = x @ p["pw1"]["w"] + p["pw1"]["b"]
    x = F.gelu(x, approximate="none")
    x = x @ p["pw2"]["w"] + p["pw2"]["b"]
    x = x * p["gamma"]
    return inp + x.transpose(1, 2)


def _vq_embed_codes(vq: Params, codes):
    """codes (B, T) -> out_proj(codebook[codes]) (B, C, T)."""
    emb = vq["codebook"][codes]
    w = vq["out_proj"]["w"][:, :, 0]
    return torch.einsum("btd,cd->bct", emb, w) + vq["out_proj"]["b"][None, :, None]


def _vq_nearest(vq: Params, z_e):
    """Nearest codebook entry under L2 on normalized vectors, the argmax of
    their dot products: z_e (B, cb_dim, T) -> (B, T) int64."""
    enc = z_e.transpose(1, 2)
    enc = enc / (torch.linalg.vector_norm(enc, dim=-1, keepdim=True) + 1e-12)
    cb = vq["codebook"].to(enc.dtype)
    cb = cb / (torch.linalg.vector_norm(cb, dim=-1, keepdim=True) + 1e-12)
    return torch.argmax(torch.einsum("btd,nd->btn", enc, cb), dim=-1)


def _vq_in_proj(vq: Params, z):
    """The 1x1 ``in_proj`` conv: (B, C, T) -> (B, cb_dim, T)."""
    w = vq["in_proj"]["w"][:, :, 0]
    return torch.einsum("bct,dc->bdt", z, w) + vq["in_proj"]["b"][None, :, None]


def quantizer_latent(qp: Params, cfg: VocoderConfig, z):
    """latent (B, C, T) -> the codebooks' input (B, C, T / downsample): the
    downsampling convs and the pre transformer of ``quantizer_encode``."""
    for stage, f in zip(qp["downsample"], cfg.downsample_factor):
        z = causal_conv1d(z, stage["conv"]["w"], stage["conv"]["b"], stride=f)
        z = _convnext(stage["convnext"], z)
    return _wlt_forward(qp["pre"], cfg.quantizer_transformer, cfg.quantizer_window, z)


def vq_books(qp: Params) -> list[Params]:
    """The codebooks in code order: the semantic one, then the residual ones."""
    return [qp["semantic"], *qp["residual"]]


def quantizer_encode(qp: Params, cfg: VocoderConfig, z):
    """latent (B, C, T) -> codes (B, 1+R, T / downsample) int64."""
    return vq_encode(qp, quantizer_latent(qp, cfg, z))


def vq_encode(qp: Params, z):
    """The codebooks' input (B, C, T) -> codes (B, 1+R, T) int64: the
    semantic code, then each residual code on what the codes before it
    leave."""
    sem = _vq_nearest(qp["semantic"], _vq_in_proj(qp["semantic"], z))
    residual = z - _vq_embed_codes(qp["semantic"], sem)
    codes = [sem]
    for vq in qp["residual"]:
        c = _vq_nearest(vq, _vq_in_proj(vq, residual))
        codes.append(c)
        residual = residual - _vq_embed_codes(vq, c)
    return torch.stack(codes, dim=1)


def encoder_forward(ep: Params, cfg: VocoderConfig, x):
    """audio (B, 1, T) -> latent (B, latent_dim, T / hop)."""
    d = cfg.encoder_dim
    x = causal_conv1d(x, ep["stem"]["w"], ep["stem"]["b"])
    for block, stride, n_t in zip(ep["blocks"], cfg.encoder_rates,
                                  cfg.encoder_transformer_layers):
        d *= 2
        for dil, unit in zip((1, 3, 9), block["units"]):
            x = _residual_unit(unit, x, dil)
        x = snake(x, block["snake"])
        x = causal_conv1d(x, block["down"]["w"], block["down"]["b"], stride=stride)
        if n_t > 0:
            x = _wlt_forward(block["wlt"], _stage_tcfg(d, n_t), cfg.encoder_window, x)
    x = snake(x, ep["final_snake"])
    return causal_conv1d(x, ep["final_conv"]["w"], ep["final_conv"]["b"])


def quantizer_decode(qp: Params, cfg: VocoderConfig, indices):
    """codes (B, 1+R, T) -> latent (B, C, T*downsample); out-of-range codes
    clamp."""
    indices = indices.long()
    sem = indices[:, 0].clamp(0, cfg.semantic_codebook_size - 1)
    res = indices[:, 1:].clamp(0, cfg.residual_codebook_size - 1)
    z = _vq_embed_codes(qp["semantic"], sem)
    for i, vq in enumerate(qp["residual"]):
        z = z + _vq_embed_codes(vq, res[:, i])
    z = _wlt_forward(qp["post"], cfg.quantizer_transformer, cfg.quantizer_window, z)
    for stage, f in zip(qp["upsample"], tuple(reversed(cfg.downsample_factor))):
        z = causal_conv_transpose1d(z, stage["tconv"]["w"], stage["tconv"]["b"], stride=f)
        z = _convnext(stage["convnext"], z)
    return z


def decoder_forward(dp: Params, cfg: VocoderConfig, z):
    """latent (B, C, T) -> audio (B, 1, T*hop)."""
    x = causal_conv1d(z, dp["stem"]["w"], dp["stem"]["b"])
    for block, stride in zip(dp["blocks"], cfg.decoder_rates):
        x = snake(x, block["snake"])
        x = causal_conv_transpose1d(x, block["up"]["w"], block["up"]["b"], stride=stride)
        for dil, unit in zip((1, 3, 9), block["units"]):
            x = _residual_unit(unit, x, dil)
    x = snake(x, dp["final_snake"])
    x = causal_conv1d(x, dp["final_conv"]["w"], dp["final_conv"]["b"])
    return torch.tanh(x)


@torch.no_grad()
def dac_decode(params: Params, cfg: VocoderConfig, indices):
    """codes (B, 1+R, N) -> audio (B, 1, N*frame_length)."""
    z = quantizer_decode(params["quantizer"], cfg, indices)
    return decoder_forward(params["decoder"], cfg, z)


@torch.no_grad()
def dac_encode(params: Params, cfg: VocoderConfig, audio):
    """audio (B, 1, T) -> codes (B, 1+R, ceil(T / frame_length)) int64: the
    audio right-padded with zeros to a whole number of frames, encoded and
    quantized."""
    fl = cfg.frame_length
    audio = F.pad(audio, (0, -(-audio.shape[-1] // fl) * fl - audio.shape[-1]))
    z = encoder_forward(params["encoder"], cfg, audio)
    return quantizer_encode(params["quantizer"], cfg, z)
