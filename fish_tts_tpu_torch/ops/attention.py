"""Attention ops (port of ``fish_tts_tpu/ops/attention.py``).

Masks are additive biases of 0 or ``finfo(f32).min``; GQA folds the query
heads into groups over the KV heads; softmax runs in f32.
"""

from __future__ import annotations

import math

import torch

NEG_INF = float(torch.finfo(torch.float32).min)
CACHE_BLOCK = 256  # keys per step of the two-part attention's walk over the cache


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
    """Exact attention over [cache ++ current block]; the cache is read-only.

    q (B, Hq, Tq, D); k/v_cache (B, Hkv, S, D); cache_bias (B, 1, Tq, S);
    k/v_new (B, Hkv, Tq, D); block_bias (B|1, 1, Tq, Tq).

    The JAX package takes one softmax over the joined key axis.  Here the
    block's own keys come first and the cache follows in CACHE_BLOCK-key
    blocks, folded into a running (max, denominator, weighted sum) in f32,
    so every product and reduction has the same shape whatever S is.  A
    block that ``cache_bias`` masks whole for a row adds exact zeros to it:
    a row's output has the same bits at every read window past its length,
    which a pool's window, set by its longest stream, needs to leave each
    stream's codes independent of its co-tenants.  Each query row must see
    at least one of its block's keys (a causal ``block_bias`` does).
    """
    B, Hq, Tq, D = q.shape
    Hkv = k_cache.shape[1]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, Tq, D).float()
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k_new.float()) * scale + block_bias[:, :, None]
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    den = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhgqk,bhkd->bhgqd", p, v_new.float())
    for j in range(0, k_cache.shape[2], CACHE_BLOCK):
        blk = slice(j, j + CACHE_BLOCK)
        s = (torch.einsum("bhgqd,bhkd->bhgqk", qg, k_cache[:, :, blk].float()) * scale
             + cache_bias[:, :, None, :, blk])
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        a = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        den = den * a + p.sum(dim=-1, keepdim=True)
        acc = acc * a + torch.einsum("bhgqk,bhkd->bhgqd", p, v_cache[:, :, blk].float())
        m = m_new
    return (acc / den).to(v_cache.dtype).reshape(B, Hq, Tq, D)


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
