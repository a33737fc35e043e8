"""DualAR text-to-semantic transformer (port of ``fish_tts_tpu/models/dual_ar.py``).

Parameters are a plain dictionary of tensors with the JAX package's key
tree; per-layer weights are stacked along a leading layer axis.  Linear
weights are ``(out, in)`` (see ``utils/quantize.py``).  This module holds
the plain PyTorch pieces: initialization, RoPE tables, the KV cache, the
input embedding, the multi-token (prefill) transformer stack, the LM head
and the fast-transformer input bridge.  The single-token decode forward
runs in the kernels of ``ops/slow_stack.py`` and ``ops/fast_decoder.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from fish_tts_tpu_torch.config import DualARConfig
from fish_tts_tpu_torch.ops.attention import NEG_INF, gqa_attention, gqa_attention_two_part
from fish_tts_tpu_torch.ops.norms import rms_norm
from fish_tts_tpu_torch.ops.rope import apply_rotary_emb, precompute_freqs_cis
from fish_tts_tpu_torch.utils.quantize import is_quantized, qgather, qhead, qmm

Params = dict[str, Any]


@dataclass(frozen=True)
class TokenIds:
    """Special-token ids the model math depends on."""

    semantic_begin: int
    semantic_end: int
    im_end: int


# ---------------------------------------------------------------------------
# Parameter initialization
# ---------------------------------------------------------------------------


def _normal(gen: torch.Generator, shape, std, dtype) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (w * std).to(dtype)


def _init_block_stack(gen, cfg: DualARConfig, n_layers: int, dtype) -> Params:
    """Stacked (out, in) block weights with a leading layer axis."""
    std = 0.02
    dev = gen.device
    qkv_out = (cfg.n_head + 2 * cfg.n_local_heads) * cfg.head_dim
    p: Params = {
        "wqkv": _normal(gen, (n_layers, qkv_out, cfg.dim), std, dtype),
        "wo": _normal(gen, (n_layers, cfg.dim, cfg.n_head * cfg.head_dim), std, dtype),
        "w1": _normal(gen, (n_layers, cfg.intermediate_size, cfg.dim), std, dtype),
        "w3": _normal(gen, (n_layers, cfg.intermediate_size, cfg.dim), std, dtype),
        "w2": _normal(gen, (n_layers, cfg.dim, cfg.intermediate_size), std, dtype),
        "attention_norm": torch.ones((n_layers, cfg.dim), dtype=dtype, device=dev),
        "ffn_norm": torch.ones((n_layers, cfg.dim), dtype=dtype, device=dev),
    }
    if cfg.attention_qkv_bias:
        p["wqkv_b"] = torch.zeros((n_layers, qkv_out), dtype=dtype, device=dev)
    if cfg.attention_o_bias:
        p["wo_b"] = torch.zeros((n_layers, cfg.dim), dtype=dtype, device=dev)
    if cfg.attention_qk_norm:
        p["q_norm"] = torch.ones((n_layers, cfg.head_dim), dtype=dtype, device=dev)
        p["k_norm"] = torch.ones((n_layers, cfg.head_dim), dtype=dtype, device=dev)
    return p


def init_params(gen: torch.Generator, cfg: DualARConfig, dtype=torch.bfloat16) -> Params:
    """Random weights (std 0.02) with the shapes of a DualAR checkpoint,
    drawn on the generator's device."""
    std = 0.02
    dev = gen.device
    params: Params = {
        "embeddings": _normal(gen, (cfg.vocab_size, cfg.dim), std, dtype),
        "codebook_embeddings": _normal(
            gen, (cfg.codebook_size * cfg.num_codebooks, cfg.dim), std, dtype),
        "layers": _init_block_stack(gen, cfg, cfg.n_layer, dtype),
        "norm": torch.ones((cfg.dim,), dtype=dtype, device=dev),
        "fast_embeddings": _normal(gen, (cfg.codebook_size, cfg.fast_dim), std, dtype),
        "fast_layers": _init_block_stack(gen, cfg.fast_config, cfg.n_fast_layer, dtype),
        "fast_norm": torch.ones((cfg.fast_dim,), dtype=dtype, device=dev),
        "fast_output": _normal(gen, (cfg.codebook_size, cfg.fast_dim), std, dtype),
    }
    if not cfg.tie_word_embeddings:
        params["output"] = _normal(gen, (cfg.vocab_size, cfg.dim), std, dtype)
    if cfg.fast_dim != cfg.dim:
        params["fast_project_in"] = {
            "w": _normal(gen, (cfg.fast_dim, cfg.dim), std, dtype),
            "b": torch.zeros((cfg.fast_dim,), dtype=dtype, device=dev),
        }
    return params


def make_rope_tables(cfg: DualARConfig, device="cpu") -> Params:
    """bf16 RoPE tables for the slow stack and the fast codebook positions."""
    return {
        "slow": precompute_freqs_cis(cfg.max_seq_len, cfg.head_dim, cfg.rope_base,
                                     device=device),
        "fast": precompute_freqs_cis(cfg.num_codebooks, cfg.fast_head_dim,
                                     cfg.rope_base, device=device),
    }


def init_kv_cache(cfg: DualARConfig, batch: int, max_seq_len: int | None = None,
                  dtype=torch.bfloat16, device="cpu") -> Params:
    """Slow-transformer KV cache: (L, B, Hkv, S, Dh) zeros."""
    s = max_seq_len or cfg.max_seq_len
    shape = (cfg.n_layer, batch, cfg.n_local_heads, s, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# Multi-token transformer stack (prefill)
# ---------------------------------------------------------------------------


def _fast_cache(cfg: DualARConfig, batch: int, dtype, device) -> Params:
    shape = (cfg.n_fast_layer, batch, cfg.fast_n_local_heads, cfg.num_codebooks,
             cfg.fast_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _layer(stack: Params, i: int) -> Params:
    out = {}
    for k, v in stack.items():
        out[k] = {"q": v["q"][i], "s": v["s"][i]} if isinstance(v, dict) else v[i]
    return out


def _attn_qkv(lp: Params, h: torch.Tensor, cfg: DualARConfig, freqs):
    """Project (plus the qkv bias), split, qk-norm, rope.  h (B, T, D) ->
    q, k, v (B, H, T, Dh)."""
    B, T, _ = h.shape
    qkv = qmm(h, lp["wqkv"])
    if "wqkv_b" in lp:
        qkv = qkv + lp["wqkv_b"]
    q_size = cfg.n_head * cfg.head_dim
    kv_size = cfg.n_local_heads * cfg.head_dim
    q, k, v = torch.split(qkv, [q_size, kv_size, kv_size], dim=-1)
    q = q.reshape(B, T, cfg.n_head, cfg.head_dim)
    k = k.reshape(B, T, cfg.n_local_heads, cfg.head_dim)
    v = v.reshape(B, T, cfg.n_local_heads, cfg.head_dim)
    if "q_norm" in lp:
        q = rms_norm(q, lp["q_norm"], cfg.norm_eps)
        k = rms_norm(k, lp["k_norm"], cfg.norm_eps)
    q, k = apply_rotary_emb(q, freqs), apply_rotary_emb(k, freqs)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def _block_body(lp, x, cfg: DualARConfig, freqs, block_bias, k_cache, v_cache, cache_bias):
    """One pre-norm block over T tokens; attention is joint over the
    read-only cache (under ``cache_bias``) and the block's own keys.
    Returns (x, new_k (B, Hkv, T, Dh), new_v)."""
    B, T, _ = x.shape
    h = rms_norm(x, lp["attention_norm"], cfg.norm_eps)
    q, k, v = _attn_qkv(lp, h, cfg, freqs)
    q_size = cfg.n_head * cfg.head_dim
    if k_cache is not None:
        attn = gqa_attention_two_part(q, k_cache, v_cache, cache_bias, k, v, block_bias)
    else:
        attn = gqa_attention(q, k, v, block_bias)
    attn = attn.transpose(1, 2).reshape(B, T, q_size)
    o = qmm(attn, lp["wo"])
    if "wo_b" in lp:
        o = o + lp["wo_b"]
    x = x + o
    f = rms_norm(x, lp["ffn_norm"], cfg.norm_eps)
    gate = qmm(f, lp["w1"])
    x = x + qmm(gate * torch.sigmoid(gate) * qmm(f, lp["w3"]), lp["w2"])
    return x, k, v


def transformer_stack(stack_params: Params, x, cfg: DualARConfig, freqs, bias,
                      kv_cache: Params, positions, cache_bias=None,
                      read_len: int | None = None, skip: torch.Tensor | None = None):
    """All layers over a T-token block, writing the block's K/V rows into
    ``kv_cache`` in place at ``positions`` (B, T).

    ``read_len`` bounds the cache rows attention reads (0: none — a fresh
    prefill); ``cache_bias`` then has key width ``read_len``.  With a set
    ``skip`` flag (0-dim bool) the rows written are the ones already there,
    so the cache stays as it was.  Returns x.
    """
    n_layers = stack_params["attention_norm"].shape[0]
    kc_all, vc_all = kv_cache["k"], kv_cache["v"]
    b_idx = torch.arange(x.shape[0], device=x.device)[:, None]
    pos = positions.long()
    for i in range(n_layers):
        lp = _layer(stack_params, i)
        if read_len == 0:
            kc = vc = None
        else:
            R = kc_all.shape[3] if read_len is None else read_len
            kc, vc = kc_all[i, :, :, :R], vc_all[i, :, :, :R]
        x, new_k, new_v = _block_body(lp, x, cfg, freqs, bias, kc, vc, cache_bias)
        # (B, Hkv, T, Dh) rows -> cache[i, b, :, pos[b, t]]
        for cache, new in ((kc_all[i], new_k), (vc_all[i], new_v)):
            rows = new.transpose(1, 2).to(cache.dtype)
            if skip is not None:
                rows = torch.where(skip, cache[b_idx, :, pos], rows)
            cache[b_idx, :, pos] = rows
    return x


def embed_inputs(params: Params, cfg: DualARConfig, ids: TokenIds, inp: torch.Tensor):
    """Token + summed codebook embeddings, the codebook part only at
    semantic-token positions.  ``inp`` (B, 1+K, T) int -> (B, T, D)."""
    tokens = inp[:, 0].long()
    dtype = params["norm"].dtype
    token_emb = qgather(params["embeddings"], tokens, dtype)
    offsets = (torch.arange(cfg.num_codebooks, device=inp.device)
               * cfg.codebook_size)[None, :, None]
    cb_emb = qgather(params["codebook_embeddings"], inp[:, 1:].long() + offsets, dtype)
    vq_sum = cb_emb.sum(dim=1)
    vq_mask = (tokens >= ids.semantic_begin) & (tokens <= ids.semantic_end)
    x = token_emb + torch.where(vq_mask[..., None], vq_sum, torch.zeros_like(vq_sum))
    if cfg.scale_codebook_embeddings:
        x = torch.where(vq_mask[..., None], x / np.sqrt(cfg.num_codebooks + 1), x)
    return x.to(dtype)


def slow_forward(params, cfg, ids, rope, inp, positions, kv_cache, cache_bias,
                 block_bias, read_len=None, skip=None):
    """Slow-transformer forward over a block, writing into the KV cache
    (unless ``skip`` is set).  Returns hidden (B, T, D) before the final
    norm."""
    x = embed_inputs(params, cfg, ids, inp)
    freqs = rope["slow"][positions.long()]
    return transformer_stack(params["layers"], x, cfg, freqs, block_bias, kv_cache,
                             positions, cache_bias=cache_bias, read_len=read_len, skip=skip)


def lm_logits(params: Params, cfg: DualARConfig, hidden: torch.Tensor) -> torch.Tensor:
    """Final norm + LM head: the tied embedding table, or the untied
    ``output`` weight."""
    h = rms_norm(hidden, params["norm"], cfg.norm_eps)
    if cfg.tie_word_embeddings:
        return qhead(h, params["embeddings"])
    return qmm(h, params["output"])


def project_fast_in(params: Params, hidden: torch.Tensor) -> torch.Tensor:
    """Dim bridge into the fast transformer, on the pre-final-norm hidden."""
    if "fast_project_in" in params:
        p = params["fast_project_in"]
        return hidden @ p["w"].transpose(0, 1) + p["b"]
    return hidden


def fast_step(params: Params, cfg: DualARConfig, rope: Params, x: torch.Tensor, pos: int,
              fast_cache: Params) -> torch.Tensor:
    """One fast-transformer step at codebook position ``pos``: x (B, 1, Df)
    is that position's input; writes its K/V row into ``fast_cache`` in
    place.  Returns the codebook logits (B, 1, C)."""
    B = x.shape[0]
    dev = x.device
    freqs = rope["fast"][pos:pos + 1]  # (1, Dh/2, 2)
    # the cache holds positions < pos; the current one is the block's self-key
    k_pos = torch.arange(cfg.num_codebooks, device=dev)
    zero = torch.zeros((), device=dev)
    cache_bias = torch.where(k_pos < pos, zero, NEG_INF).expand(B, 1, 1, cfg.num_codebooks)
    block_bias = torch.zeros((1, 1, 1, 1), device=dev)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=dev)
    x = transformer_stack(params["fast_layers"], x, cfg.fast_config, freqs, block_bias,
                          fast_cache, positions, cache_bias=cache_bias)
    h = rms_norm(x, params["fast_norm"], cfg.norm_eps)
    return qmm(h, params["fast_output"])


def new_fast_cache(params: Params, cfg: DualARConfig, batch: int) -> Params:
    """A fresh per-frame fast KV cache in the parameters' dtype and device."""
    norm = params["norm"]
    return _fast_cache(cfg, batch, norm.dtype, norm.device)


def cast_params(params: Params, dtype: torch.dtype) -> Params:
    """Cast floating leaves to ``dtype``, leaving quantized ``{"q", "s"}``
    weights alone: their f32 scales must not be rounded."""
    def walk(p):
        if is_quantized(p):
            return p
        if isinstance(p, dict):
            return {k: walk(v) for k, v in p.items()}
        if isinstance(p, (list, tuple)):
            return type(p)(walk(v) for v in p)
        return p.to(dtype) if p.is_floating_point() else p

    return {k: walk(v) for k, v in params.items()}
