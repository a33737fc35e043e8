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
from fish_tts_tpu_torch.ops.attention import gqa_attention, gqa_attention_two_part
from fish_tts_tpu_torch.ops.norms import rms_norm
from fish_tts_tpu_torch.ops.rope import apply_rotary_emb, precompute_freqs_cis
from fish_tts_tpu_torch.utils.quantize import qgather, qhead, qmm

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
    if cfg.attention_qkv_bias or cfg.attention_o_bias or cfg.attention_qk_norm:
        raise NotImplementedError("qkv/o biases and qk-norm are not ported yet")
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


def _layer(stack: Params, i: int) -> Params:
    out = {}
    for k, v in stack.items():
        out[k] = {"q": v["q"][i], "s": v["s"][i]} if isinstance(v, dict) else v[i]
    return out


def _block_body(lp, x, cfg: DualARConfig, freqs, block_bias, k_cache, v_cache, cache_bias):
    """One pre-norm block over T tokens; attention is joint over the
    read-only cache (under ``cache_bias``) and the block's own keys.
    Returns (x, new_k (B, Hkv, T, Dh), new_v)."""
    B, T, _ = x.shape
    h = rms_norm(x, lp["attention_norm"], cfg.norm_eps)
    qkv = qmm(h, lp["wqkv"])
    q_size = cfg.n_head * cfg.head_dim
    kv_size = cfg.n_local_heads * cfg.head_dim
    q, k, v = torch.split(qkv, [q_size, kv_size, kv_size], dim=-1)
    q = apply_rotary_emb(q.reshape(B, T, cfg.n_head, cfg.head_dim), freqs)
    k = apply_rotary_emb(k.reshape(B, T, cfg.n_local_heads, cfg.head_dim), freqs)
    v = v.reshape(B, T, cfg.n_local_heads, cfg.head_dim)
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if k_cache is not None:
        attn = gqa_attention_two_part(q, k_cache, v_cache, cache_bias, k, v, block_bias)
    else:
        attn = gqa_attention(q, k, v, block_bias)
    attn = attn.transpose(1, 2).reshape(B, T, q_size)
    x = x + qmm(attn, lp["wo"])
    f = rms_norm(x, lp["ffn_norm"], cfg.norm_eps)
    gate = qmm(f, lp["w1"])
    x = x + qmm(gate * torch.sigmoid(gate) * qmm(f, lp["w3"]), lp["w2"])
    return x, k, v


def transformer_stack(stack_params: Params, x, cfg: DualARConfig, freqs, bias,
                      kv_cache: Params, positions, cache_bias=None,
                      read_len: int | None = None):
    """All layers over a T-token block, writing the block's K/V rows into
    ``kv_cache`` in place at ``positions`` (B, T).

    ``read_len`` bounds the cache rows attention reads (0: none — a fresh
    prefill); ``cache_bias`` then has key width ``read_len``.  Returns x.
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
        kc_all[i][b_idx, :, pos] = new_k.transpose(1, 2).to(kc_all.dtype)
        vc_all[i][b_idx, :, pos] = new_v.transpose(1, 2).to(vc_all.dtype)
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
                 block_bias, read_len=None):
    """Slow-transformer forward over a block, writing into the KV cache.
    Returns hidden (B, T, D) before the final norm."""
    x = embed_inputs(params, cfg, ids, inp)
    freqs = rope["slow"][positions.long()]
    return transformer_stack(params["layers"], x, cfg, freqs, block_bias, kv_cache,
                             positions, cache_bias=cache_bias, read_len=read_len)


def lm_logits(params: Params, cfg: DualARConfig, hidden: torch.Tensor) -> torch.Tensor:
    """Final norm + (tied) LM head."""
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
