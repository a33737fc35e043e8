"""Attention ops (port of ``fish_tts_tpu/ops/attention.py``).

Masks are additive biases of 0 or ``finfo(f32).min``; GQA folds the query
heads into groups over the KV heads; softmax runs in f32.
"""

from __future__ import annotations

import math

import torch

NEG_INF = float(torch.finfo(torch.float32).min)


def window_causal_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, window: int) -> torch.Tensor:
    """Sliding-window causal bias: attend to ``q_pos-window+1 .. q_pos``."""
    diff = q_pos[:, None] - k_pos[None, :]
    allowed = (diff >= 0) & (diff < window)
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(allowed, zero, NEG_INF)[None, None]


def attention(q, k, v, bias=None):
    """Dense attention, q/k/v (B, H, T, D); GQA when k has fewer heads."""
    if q.shape[1] != k.shape[1]:
        return gqa_attention(q, k, v, bias)
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        scores = scores + bias
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def gqa_attention_two_part(q, k_cache, v_cache, cache_bias, k_new, v_new, block_bias):
    """Exact attention over [cache ++ current block] with one softmax over
    the joined key axis; the cache is read-only.

    q (B, Hq, Tq, D); k/v_cache (B, Hkv, S, D); cache_bias (B, 1, Tq, S);
    k/v_new (B, Hkv, Tq, D); block_bias (B|1, 1, Tq, Tq).
    """
    B, Hq, Tq, D = q.shape
    Hkv = k_cache.shape[1]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, Tq, D).float()
    scale = 1.0 / math.sqrt(D)
    s_cache = torch.einsum("bhgqd,bhkd->bhgqk", qg, k_cache.float()) * scale
    s_cache = s_cache + cache_bias[:, :, None]
    s_new = torch.einsum("bhgqd,bhkd->bhgqk", qg, k_new.float()) * scale
    s_new = s_new + block_bias[:, :, None]
    probs = torch.softmax(torch.cat([s_cache, s_new], dim=-1), dim=-1)
    S = k_cache.shape[2]
    p_cache = probs[..., :S].to(v_cache.dtype)
    p_new = probs[..., S:].to(v_new.dtype)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p_cache, v_cache)
    out = out + torch.einsum("bhgqk,bhkd->bhgqd", p_new, v_new)
    return out.reshape(B, Hq, Tq, D)


def gqa_attention(q, k, v, bias=None):
    """GQA attention without KV repetition: q (B, Hq, Tq, D), k/v
    (B, Hkv, Tk, D), bias broadcastable to (1|B, 1, Tq, Tk)."""
    B, Hq, Tq, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, Tq, D).float()
    scale = 1.0 / math.sqrt(D)
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    if bias is not None:
        scores = scores + bias[:, :, None]
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, v)
    return out.reshape(B, Hq, Tq, D)
