"""DualAR text-to-semantic transformer (port of ``fish_tts_tpu/models/dual_ar.py``).

Parameters are a plain dictionary of tensors with the JAX package's key
tree; per-layer weights are stacked along a leading layer axis.  Linear
weights are ``(out, in)`` (see ``utils/quantize.py``).  This module holds
the plain PyTorch pieces: initialization, RoPE tables, the KV cache, the
input embedding, the multi-token (prefill) transformer stack, the LM head
and the fast-transformer input bridge.  The single-token decode forward
runs in the kernels of ``ops/slow_stack.py`` and ``ops/fast_decoder.py``.

On a (dp, tp) mesh (``parameters`` a ``parallel.sharding.MeshParams``, the
caches ``ShardedKV``s) the same functions take the mesh route: each dp row
computes its batch rows with its own replica, each tp rank its share of the
heads and of the FFN's hidden dim (``sharding.local_config``); the partial
products after ``wo`` and ``w2`` are summed in float32 and rounded once
(``collectives.reduce_sum``), the vocab-sharded embedding is a masked
gather per rank and a sum, and the vocab- and codebook-sharded heads are
gathered to full width.  The kernels are single-device: the mesh route is
the plain one.  On one device every call takes the code it always took.
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
from fish_tts_tpu_torch.parallel import collectives, sharding
from fish_tts_tpu_torch.parallel.sharding import MeshParams
from fish_tts_tpu_torch.utils.checkpoint import flatten_params
from fish_tts_tpu_torch.utils.quantize import is_quantized, qgather, qhead, qmm, qmm_f32

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


def _zeros_kv(shape, dtype, device, mesh) -> Params:
    if mesh is not None:
        return {"k": sharding.kv_zeros(mesh, shape, dtype),
                "v": sharding.kv_zeros(mesh, shape, dtype)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_kv_cache(cfg: DualARConfig, batch: int, max_seq_len: int | None = None,
                  dtype=torch.bfloat16, device="cpu", mesh=None) -> Params:
    """Slow-transformer KV cache: (L, B, Hkv, S, Dh) zeros; on a ``mesh``,
    ``ShardedKV``s over (dp rows of the batch, tp KV heads)."""
    s = max_seq_len or cfg.max_seq_len
    shape = (cfg.n_layer, batch, cfg.n_local_heads, s, cfg.head_dim)
    return _zeros_kv(shape, dtype, device, mesh)


# ---------------------------------------------------------------------------
# Multi-token transformer stack (prefill)
# ---------------------------------------------------------------------------


def _fast_cache(cfg: DualARConfig, batch: int, dtype, device, mesh=None) -> Params:
    shape = (cfg.n_fast_layer, batch, cfg.fast_n_local_heads, cfg.num_codebooks,
             cfg.fast_head_dim)
    return _zeros_kv(shape, dtype, device, mesh)


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


def _attention(lp, h, cfg: DualARConfig, freqs, block_bias, k_cache, v_cache, cache_bias):
    """Attention of a normed block h (B, T, D) over the read-only cache
    (under ``cache_bias``) and the block's own keys.  Returns (the heads'
    output (B, T, Hq*Dh) before ``wo``, new_k (B, Hkv, T, Dh), new_v)."""
    B, T, _ = h.shape
    q, k, v = _attn_qkv(lp, h, cfg, freqs)
    if k_cache is not None:
        attn = gqa_attention_two_part(q, k_cache, v_cache, cache_bias, k, v, block_bias)
    else:
        attn = gqa_attention(q, k, v, block_bias)
    return attn.transpose(1, 2).reshape(B, T, cfg.n_head * cfg.head_dim), k, v


def _swiglu(lp, f):
    """The FFN's gated hidden activation, before ``w2``."""
    gate = qmm(f, lp["w1"])
    return gate * torch.sigmoid(gate) * qmm(f, lp["w3"])


def _block_body(lp, x, cfg: DualARConfig, freqs, block_bias, k_cache, v_cache, cache_bias):
    """One pre-norm block over T tokens; attention is joint over the
    read-only cache (under ``cache_bias``) and the block's own keys.
    Returns (x, new_k (B, Hkv, T, Dh), new_v)."""
    h = rms_norm(x, lp["attention_norm"], cfg.norm_eps)
    attn, k, v = _attention(lp, h, cfg, freqs, block_bias, k_cache, v_cache, cache_bias)
    o = qmm(attn, lp["wo"])
    if "wo_b" in lp:
        o = o + lp["wo_b"]
    x = x + o
    f = rms_norm(x, lp["ffn_norm"], cfg.norm_eps)
    x = x + qmm(_swiglu(lp, f), lp["w2"])
    return x, k, v


def _write_rows(cache, new, b_idx, pos, skip) -> None:
    """A block's (B, Hkv, T, Dh) K or V rows into one layer's cache (B, Hkv,
    S, Dh) at ``pos`` (B, T), in place (the rows already there under a set
    ``skip``)."""
    rows = new.transpose(1, 2).to(cache.dtype)
    if skip is not None:
        rows = torch.where(skip, cache[b_idx, :, pos], rows)
    cache[b_idx, :, pos] = rows


def _read(cache_l, read_len):
    """One layer's cache rows attention reads (None for a fresh prefill)."""
    if read_len == 0:
        return None
    return cache_l[:, :, :(cache_l.shape[2] if read_len is None else read_len)]


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
        kc, vc = _read(kc_all[i], read_len), _read(vc_all[i], read_len)
        x, new_k, new_v = _block_body(lp, x, cfg, freqs, bias, kc, vc, cache_bias)
        # (B, Hkv, T, Dh) rows -> cache[i, b, :, pos[b, t]]
        _write_rows(kc_all[i], new_k, b_idx, pos, skip)
        _write_rows(vc_all[i], new_v, b_idx, pos, skip)
    return x


# ---------------------------------------------------------------------------
# The mesh route
# ---------------------------------------------------------------------------


def _batch_part(t, a: int, b: int, device):
    """Rows [a, b) of a per-stream tensor (whole when it broadcasts over the
    batch), on ``device``."""
    if t is None:
        return None
    return (t if t.shape[0] == 1 else t[a:b]).to(device)


def _stack_tp(ranks: list[Params], key: str, x, cfg: DualARConfig, freqs, bias, caches,
              positions, cache_bias, read_len, skip):
    """``transformer_stack`` over one dp row's tp ranks: x (b, T, D) on the
    row's first device; ``ranks[r][key]`` rank r's layer stack and
    ``caches[r]`` its {"k", "v"} (L, b, Hkv/tp, S, Dh) on its device.  Each
    rank attends with its heads and writes its KV heads' rows; the
    row-parallel products after ``wo`` and ``w2`` are reduced once each.
    With one rank it is ``transformer_stack`` itself."""
    if len(ranks) == 1:
        return transformer_stack(ranks[0][key], x, cfg, freqs, bias, caches[0], positions,
                                 cache_bias=cache_bias, read_len=read_len, skip=skip)
    lcfg = sharding.local_config(cfg, len(ranks))
    devs = [p["norm"].device for p in ranks]
    lead = x.device
    per = [dict(freqs=freqs.to(d), bias=bias.to(d), pos=positions.long().to(d),
                cache_bias=None if cache_bias is None else cache_bias.to(d),
                skip=None if skip is None else skip.to(d),
                b_idx=torch.arange(x.shape[0], device=d)[:, None]) for d in devs]
    for i in range(ranks[0][key]["attention_norm"].shape[0]):
        lps = [_layer(p[key], i) for p in ranks]
        partials = []
        for r, xr in enumerate(collectives.broadcast(x, devs)):
            lp, c, kv = lps[r], per[r], caches[r]
            h = rms_norm(xr, lp["attention_norm"], cfg.norm_eps)
            attn, new_k, new_v = _attention(lp, h, lcfg, c["freqs"], c["bias"],
                                            _read(kv["k"][i], read_len),
                                            _read(kv["v"][i], read_len), c["cache_bias"])
            _write_rows(kv["k"][i], new_k, c["b_idx"], c["pos"], c["skip"])
            _write_rows(kv["v"][i], new_v, c["b_idx"], c["pos"], c["skip"])
            partials.append(qmm_f32(attn, lp["wo"]))
        o = collectives.reduce_sum(partials, lead, x.dtype)
        if "wo_b" in lps[0]:
            o = o + lps[0]["wo_b"]
        x = x + o
        partials = [qmm_f32(_swiglu(lp, rms_norm(xr, lp["ffn_norm"], cfg.norm_eps)), lp["w2"])
                    for lp, xr in zip(lps, collectives.broadcast(x, devs))]
        x = x + collectives.reduce_sum(partials, lead, x.dtype)
    return x


def _stack_mesh(params: MeshParams, key: str, rows_in, cfg: DualARConfig, kv_cache: Params,
                read_len=None, skip=None):
    """A layer stack on the mesh: each block of the cache's batch rows on its
    dp row, whose first device gets that block's (x, freqs, bias, positions,
    cache_bias) from ``rows_in(i, a, b, device)`` (dp row i, rows [a, b)).
    Returns x (B, T, D) on the mesh's first device."""
    first = params.mesh.first
    out = []
    for (i, a, parts_k), (_, _, parts_v) in zip(kv_cache["k"].blocks, kv_cache["v"].blocks):
        lead = params.mesh.grid[i][0]
        x, freqs, bias, positions, cache_bias = rows_in(i, a, a + parts_k[0].shape[1], lead)
        x = _stack_tp(params.ranks[i], key, x, cfg, freqs, bias,
                      [{"k": k, "v": v} for k, v in zip(parts_k, parts_v)], positions,
                      cache_bias, read_len, None if skip is None else skip.to(lead))
        out.append(x.to(first))
    return out[0] if len(out) == 1 else torch.cat(out)


def _vocab_parallel_embed(ranks: list[Params], tokens: torch.Tensor, dtype) -> torch.Tensor:
    """The vocab-sharded embedding: each rank gathers the rows it owns and
    zeros for the others; the sum lands on ``tokens``' device."""
    parts = []
    for p in ranks:
        table = p["embeddings"]
        n = (table["q"] if is_quantized(table) else table).shape[0]
        t = tokens.to(p["norm"].device) - len(parts) * n
        rows = qgather(table, t.clamp(0, n - 1), dtype)
        parts.append(torch.where(((t >= 0) & (t < n))[..., None], rows, torch.zeros_like(rows)))
    return collectives.reduce_sum(parts, tokens.device, dtype)


def embed_inputs(params: Params, cfg: DualARConfig, ids: TokenIds, inp: torch.Tensor,
                 row: int = 0):
    """Token + summed codebook embeddings, the codebook part only at
    semantic-token positions.  ``inp`` (B, 1+K, T) int -> (B, T, D); on a
    mesh, computed by dp row ``row`` on its first device."""
    tokens = inp[:, 0].long()
    dtype = params["norm"].dtype
    if isinstance(params, MeshParams):
        ranks = params.ranks[row]
        params = ranks[0]  # its whole codebook table, on the row's first device
        inp = inp.to(params["norm"].device)
        tokens = tokens.to(inp.device)
        token_emb = _vocab_parallel_embed(ranks, tokens, dtype)
    else:
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
    if isinstance(params, MeshParams):
        def rows_in(i, a, b, dev):
            return (embed_inputs(params, cfg, ids, inp[a:b], row=i),
                    rope["slow"][positions[a:b].long()].to(dev), _batch_part(block_bias, a, b, dev),
                    positions[a:b].to(dev), _batch_part(cache_bias, a, b, dev))
        return _stack_mesh(params, "layers", rows_in, cfg, kv_cache, read_len, skip)
    x = embed_inputs(params, cfg, ids, inp)
    freqs = rope["slow"][positions.long()]
    return transformer_stack(params["layers"], x, cfg, freqs, block_bias, kv_cache,
                             positions, cache_bias=cache_bias, read_len=read_len, skip=skip)


def lm_logits(params: Params, cfg: DualARConfig, hidden: torch.Tensor) -> torch.Tensor:
    """Final norm + LM head: the tied embedding table, or the untied
    ``output`` weight."""
    if isinstance(params, MeshParams):
        tied = cfg.tie_word_embeddings
        return _head_mesh(params, cfg, hidden, "norm", "embeddings" if tied else "output",
                          qhead if tied else qmm)
    h = rms_norm(hidden, params["norm"], cfg.norm_eps)
    if cfg.tie_word_embeddings:
        return qhead(h, params["embeddings"])
    return qmm(h, params["output"])


def _head_mesh(params: MeshParams, cfg: DualARConfig, x, norm: str, weight: str, head):
    """A final norm and a vocab- or codebook-sharded head on the mesh: each
    dp row's batch rows against every rank's slice, gathered to full width
    on the mesh's first device."""
    out = []
    for i, a, b in sharding.batch_rows(x.shape[0], params.mesh):
        ranks = params.ranks[i]
        h = rms_norm(x[a:b].to(ranks[0][norm].device), ranks[0][norm], cfg.norm_eps)
        parts = [head(hr, p[weight]) for p, hr in
                 zip(ranks, collectives.broadcast(h, [p[norm].device for p in ranks]))]
        out.append(collectives.gather(parts, -1, params.mesh.first))
    return out[0] if len(out) == 1 else torch.cat(out)


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
    if isinstance(params, MeshParams):
        def rows_in(i, a, b, d):
            return (x[a:b].to(d), freqs.to(d), block_bias.to(d), positions[a:b].to(d),
                    cache_bias[a:b].to(d))
        x = _stack_mesh(params, "fast_layers", rows_in, cfg.fast_config, fast_cache)
        return _head_mesh(params, cfg, x, "fast_norm", "fast_output", qmm)
    x = transformer_stack(params["fast_layers"], x, cfg.fast_config, freqs, block_bias,
                          fast_cache, positions, cache_bias=cache_bias)
    h = rms_norm(x, params["fast_norm"], cfg.norm_eps)
    return qmm(h, params["fast_output"])


def new_fast_cache(params: Params, cfg: DualARConfig, batch: int) -> Params:
    """A fresh per-frame fast KV cache in the parameters' dtype and device."""
    norm = params["norm"]
    return _fast_cache(cfg, batch, norm.dtype, norm.device, sharding.mesh_of(params))


def param_count(params: Params) -> int:
    """Elements in every leaf (an int8 weight counts its values and its
    scales)."""
    return sum(t.numel() for t in flatten_params(params).values())


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
