"""Stateful streaming codec decode (port of ``fish_tts_tpu/models/vocoder_stream.py``).

The codec's decode path is causal with a finite receptive field, so a
chunk of frames decodes exactly from its own codes plus a carried state:

- stride-1 causal convs carry their last ``(k-1)*dilation`` input samples
  (the left pad of the next chunk);
- causal transposed convs carry the ``k - stride`` output samples that
  spill past the chunk's end and add them into the next chunk's head; the
  bias lands once, on emitted samples, and the spill is carried without it;
- the window-limited transformer carries the last ``window`` positions'
  keys and values per layer, keys stored after RoPE at absolute positions
  (slots at position -1 are invalid);
- Snake, the norms and the projections are pointwise and carry nothing.

So :func:`decode_chunk`, over any cutting of a code sequence into chunks,
gives the waveform of one ``vocoder.dac_decode`` of the whole sequence, to
floating-point tolerance, with work proportional to the chunk.

The state is a plain dict of tensors with the JAX package's tree: "post"
{"k", "v" (L, B, Hkv, W, Dh), "pos" (B, W) int32, "off" (B,) int32},
"upsample" [{"tconv", "convnext"}], "stem", "blocks" [{"up", "units"
[{"conv1", "conv2"}] x 3}], "final".

The slot pool (:func:`decode_chunk_pool`) decodes one chunk for every row
of a batched state at once, for batched streaming: a row may restart its
stream first (``reset``) or sit the round out (``active`` False: its state
passes through and its audio lanes are garbage).  A ragged final chunk is
zero-padded to the round's width; the decode is causal, so its first
``m * frame_length`` samples are exact and the padded state advance is never
read again.
"""

from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from fish_tts_tpu_torch.config import VocoderConfig, VocoderTransformerConfig
from fish_tts_tpu_torch.models.vocoder import vq_embed_codes, rope_table, wlt_layer_body
from fish_tts_tpu_torch.ops.attention import NEG_INF
from fish_tts_tpu_torch.ops.conv import conv1d, conv_transpose1d
from fish_tts_tpu_torch.ops.norms import layer_norm, snake, vocoder_rms_norm

Params = dict[str, Any]


def _tail_len(w: torch.Tensor, dilation: int = 1) -> int:
    return (w.shape[-1] - 1) * dilation


def stream_conv(tail, x, w, b=None, dilation: int = 1, groups: int = 1):
    """Stride-1 causal conv continuation.  ``tail`` holds the last
    ``(k-1)*dilation`` inputs (zeros at the stream's start, the left pad of
    ``ops.conv.causal_conv1d``).  Returns (new_tail, the next T outputs of
    the joint convolution)."""
    n = _tail_len(w, dilation)
    if n == 0:
        return tail, conv1d(x, w, b, dilation=dilation, groups=groups)
    xin = torch.cat([tail, x.to(tail.dtype)], dim=-1)
    y = conv1d(xin, w, b, dilation=dilation, groups=groups)
    return xin[..., -n:], y


def stream_tconv(spill, x, w, b=None, stride: int = 1):
    """Causal transposed-conv continuation.  ``spill`` holds the
    ``k - stride`` output samples of the previous chunk past its
    ``T*stride`` boundary; they add into this chunk's head.  The bias lands
    once, on emitted samples (the spill is carried without it)."""
    ks = w.shape[-1] - stride
    y = conv_transpose1d(x, w, None, stride=stride)  # ((T-1)*stride + k,)
    t_out = x.shape[-1] * stride
    emit = y[..., :t_out]
    if ks > 0:
        emit = torch.cat([emit[..., :ks] + spill, emit[..., ks:]], dim=-1)
        spill = y[..., t_out:]
    if b is not None:
        emit = emit + b[None, :, None]
    return spill, emit


def stream_convnext(tail, x, p: Params):
    """ConvNeXt block continuation: the depthwise conv carries its tail, the
    rest is pointwise (``vocoder._convnext``)."""
    inp = x
    tail, x = stream_conv(tail, x, p["dwconv"]["w"], p["dwconv"]["b"], groups=x.shape[1])
    x = x.transpose(1, 2)
    x = layer_norm(x, p["norm_w"], p["norm_b"], eps=1e-6)
    x = x @ p["pw1"]["w"] + p["pw1"]["b"]
    x = F.gelu(x, approximate="none")
    x = x @ p["pw2"]["w"] + p["pw2"]["b"]
    x = x * p["gamma"]
    return tail, inp + x.transpose(1, 2)


def init_wlt_state(p: Params, tcfg: VocoderTransformerConfig, window: int, batch: int,
                   dtype) -> Params:
    """A fresh rolling KV window: ``window`` slots per layer, every one at
    position -1 (invalid); ``off`` the next position of each stream."""
    L = p["layers"]["wqkv"].shape[0]
    dev = p["layers"]["wqkv"].device
    shape = (L, batch, tcfg.n_local_heads, window, tcfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=dev),
        "v": torch.zeros(shape, dtype=dtype, device=dev),
        "pos": torch.full((batch, window), -1, dtype=torch.int32, device=dev),
        "off": torch.zeros((batch,), dtype=torch.int32, device=dev),
    }


@functools.cache
def _inv_freqs(head_dim: int, base: float, device: torch.device) -> torch.Tensor:
    """The rotary inverse frequencies (Dh/2,) f32 on ``device``; made once."""
    inv = 1.0 / (base ** (np.arange(0, head_dim, 2)[: head_dim // 2].astype(np.float32)
                          / head_dim))
    return torch.from_numpy(inv).to(device)


def _stream_freqs(tcfg: VocoderTransformerConfig, qpos: torch.Tensor) -> torch.Tensor:
    """Rotary (cos, sin) pairs at absolute positions ``qpos`` (B, T): rows of
    the table inside ``block_size`` (the joint forward's values), computed
    from the angle beyond it.  A clamped gather would freeze the rotation at
    the table's last row for the rest of a long stream."""
    table = rope_table(tcfg.block_size, tcfg.head_dim, tcfg.rope_base, qpos.device)
    inv = _inv_freqs(tcfg.head_dim, tcfg.rope_base, qpos.device)
    in_range = qpos < tcfg.block_size
    freqs = table[torch.clamp(qpos, max=tcfg.block_size - 1).long()]  # (B, T, Dh/2, 2)
    ang = qpos.float()[..., None] * inv
    computed = torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1).to(table.dtype)
    return torch.where(in_range[..., None, None], freqs, computed)


def stream_wlt(st: Params, p: Params, tcfg: VocoderTransformerConfig, window: int, x):
    """Window-limited transformer continuation on channels-first (B, C, T):
    the joint forward's math at absolute positions ``off .. off+T``, the
    previous ``window`` positions attended from the carried keys and
    values.  Returns (new state, (B, C, T))."""
    x = x.transpose(1, 2)
    if "input_proj" in p:
        x = x @ p["input_proj"]["w"] + p["input_proj"]["b"]
    T = x.shape[1]
    W = st["pos"].shape[-1]
    qpos = st["off"][:, None] + torch.arange(T, dtype=torch.int32, device=x.device)[None]
    freqs = _stream_freqs(tcfg, qpos) if tcfg.pos_embed_type == "rope" else None
    kpos = torch.cat([st["pos"], qpos], dim=1)  # (B, W + T)
    diff = qpos[:, :, None] - kpos[:, None, :]
    allowed = (diff >= 0) & (diff < window) & (kpos[:, None, :] >= 0)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    bias = torch.where(allowed, zero, NEG_INF)[:, None]
    layers = p["layers"]
    new_k, new_v = [], []
    for i in range(layers["wqkv"].shape[0]):
        lp = {k: v[i] for k, v in layers.items()}
        x, (k_all, v_all) = wlt_layer_body(lp, x, tcfg, freqs, bias,
                                           kv_cache=(st["k"][i], st["v"][i]))
        new_k.append(k_all[:, :, -W:])
        new_v.append(v_all[:, :, -W:])
    x = vocoder_rms_norm(x, p["norm"], tcfg.norm_eps)
    if "output_proj" in p:
        x = x @ p["output_proj"]["w"] + p["output_proj"]["b"]
    new_st = {"k": torch.stack(new_k), "v": torch.stack(new_v), "pos": kpos[:, -W:],
              "off": st["off"] + T}
    return new_st, x.transpose(1, 2)


def init_decode_state(params: Params, cfg: VocoderConfig, batch: int = 1) -> Params:
    """A fresh streaming-decode state for the codec's decode path (the
    quantizer's post transformer and upsampling, then the decoder), on the
    parameters' device in their dtype."""
    qp, dp = params["quantizer"], params["decoder"]
    dtype, dev = dp["stem"]["w"].dtype, dp["stem"]["w"].device
    zeros = functools.partial(torch.zeros, dtype=dtype, device=dev)
    qd = cfg.quantizer_input_dim

    def conv_tail(c_in, w, dilation=1):
        return zeros((batch, c_in, _tail_len(w, dilation)))

    upsample = [{"tconv": zeros((batch, qd, stage["tconv"]["w"].shape[-1] - f)),
                 "convnext": conv_tail(qd, stage["convnext"]["dwconv"]["w"])}
                for stage, f in zip(qp["upsample"], tuple(reversed(cfg.downsample_factor)))]
    blocks = []
    for i, (bp, stride) in enumerate(zip(dp["blocks"], cfg.decoder_rates)):
        out_dim = cfg.decoder_dim // (2 ** (i + 1))
        blocks.append({
            "up": zeros((batch, out_dim, bp["up"]["w"].shape[-1] - stride)),
            "units": [{"conv1": conv_tail(out_dim, up["conv1"]["w"], dil),
                       "conv2": conv_tail(out_dim, up["conv2"]["w"])}
                      for up, dil in zip(bp["units"], (1, 3, 9))],
        })
    return {
        "post": init_wlt_state(qp["post"], cfg.quantizer_transformer, cfg.quantizer_window,
                               batch, dtype),
        "upsample": upsample,
        "stem": conv_tail(cfg.latent_dim, dp["stem"]["w"]),
        "blocks": blocks,
        "final": conv_tail(cfg.decoder_dim // (2 ** len(cfg.decoder_rates)),
                           dp["final_conv"]["w"]),
    }


@torch.no_grad()
def decode_chunk(params: Params, cfg: VocoderConfig, state: Params, indices):
    """Decode the T frames of ``indices`` (B, 1+R, T), this chunk's codes
    only, from the carried ``state``.  Returns (new state, audio (B, 1,
    T*frame_length)): the continuation of the joint ``dac_decode``
    waveform.  Out-of-range codes clamp."""
    qp, dp = params["quantizer"], params["decoder"]
    indices = indices.long()
    sem = indices[:, 0].clamp(0, cfg.semantic_codebook_size - 1)
    res = indices[:, 1:].clamp(0, cfg.residual_codebook_size - 1)
    z = vq_embed_codes(qp["semantic"], sem)
    for i, vq in enumerate(qp["residual"]):
        z = z + vq_embed_codes(vq, res[:, i])

    post, z = stream_wlt(state["post"], qp["post"], cfg.quantizer_transformer,
                         cfg.quantizer_window, z)
    upsample = []
    for stage, st, f in zip(qp["upsample"], state["upsample"],
                            tuple(reversed(cfg.downsample_factor))):
        spill, z = stream_tconv(st["tconv"], z, stage["tconv"]["w"], stage["tconv"]["b"],
                                stride=f)
        tail, z = stream_convnext(st["convnext"], z, stage["convnext"])
        upsample.append({"tconv": spill, "convnext": tail})

    stem, x = stream_conv(state["stem"], z, dp["stem"]["w"], dp["stem"]["b"])
    blocks = []
    for bp, bst, stride in zip(dp["blocks"], state["blocks"], cfg.decoder_rates):
        x = snake(x, bp["snake"])
        spill, x = stream_tconv(bst["up"], x, bp["up"]["w"], bp["up"]["b"], stride=stride)
        units = []
        for up, ust, dil in zip(bp["units"], bst["units"], (1, 3, 9)):
            y = snake(x, up["snake1"])
            t1, y = stream_conv(ust["conv1"], y, up["conv1"]["w"], up["conv1"]["b"],
                                dilation=dil)
            y = snake(y, up["snake2"])
            t2, y = stream_conv(ust["conv2"], y, up["conv2"]["w"], up["conv2"]["b"])
            x = x + y
            units.append({"conv1": t1, "conv2": t2})
        blocks.append({"up": spill, "units": units})
    x = snake(x, dp["final_snake"])
    final, x = stream_conv(state["final"], x, dp["final_conv"]["w"], dp["final_conv"]["b"])
    new_state = {"post": post, "upsample": upsample, "stem": stem, "blocks": blocks,
                 "final": final}
    return new_state, torch.tanh(x)


# --- the slot pool ----------------------------------------------------------------


def _tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts and lists of tensors."""
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    if isinstance(trees[0], list):
        return [_tree_map(fn, *ts) for ts in zip(*trees)]
    return fn(*trees)


def _where_b(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor, bdim: int) -> torch.Tensor:
    """Per-row select with the batch on axis ``bdim``."""
    shape = [1] * a.ndim
    shape[bdim] = mask.shape[0]
    return torch.where(mask.reshape(shape), a, b)


def _pool_merge(state: Params, other: Params, take_other: torch.Tensor) -> Params:
    """Per-row state select: ``other``'s rows where ``take_other``.  The
    conv tails have their batch on axis 0, the WLT's k/v on axis 1."""
    post_s, post_o = state["post"], other["post"]
    post = {"k": _where_b(take_other, post_o["k"], post_s["k"], 1),
            "v": _where_b(take_other, post_o["v"], post_s["v"], 1),
            "pos": _where_b(take_other, post_o["pos"], post_s["pos"], 0),
            "off": torch.where(take_other, post_o["off"], post_s["off"])}
    rest = _tree_map(lambda s, o: _where_b(take_other, o, s, 0),
                     {k: v for k, v in state.items() if k != "post"},
                     {k: v for k, v in other.items() if k != "post"})
    return {"post": post, **rest}


def pool_reset(state: Params, reset: torch.Tensor) -> Params:
    """Restart the streams of the rows in ``reset`` (B,) bool: their state
    back to :func:`init_decode_state`'s values."""
    post = state["post"]
    fresh = {"post": {"k": torch.zeros_like(post["k"]), "v": torch.zeros_like(post["v"]),
                      "pos": torch.full_like(post["pos"], -1),
                      "off": torch.zeros_like(post["off"])},
             **_tree_map(torch.zeros_like, {k: v for k, v in state.items() if k != "post"})}
    return _pool_merge(state, fresh, reset)


@torch.no_grad()
def decode_chunk_pool(params: Params, cfg: VocoderConfig, state: Params, indices,
                      active: torch.Tensor, reset: torch.Tensor):
    """One slot-pool round: ``indices`` (B, 1+R, T), any codes in inactive
    rows; ``active`` (B,) bool rows that advance; ``reset`` (B,) bool rows
    that restart their stream first.  Returns (new state, audio (B, 1,
    T*frame_length)); an active row's audio continues its stream."""
    base = pool_reset(state, reset)
    new_state, audio = decode_chunk(params, cfg, base, indices)
    return _pool_merge(base, new_state, active), audio
