"""Slow-stack decode step: the one-token forward of the slow transformer
plus, for a tied head, the int8 LM head (kernel 2).

Port of ``fish_tts_tpu/ops/slow_stack.py::slow_stack_step``.  For B <= 16
streams at per-stream positions ``pos``, every layer runs RMSNorm, the
int8 ``wqkv`` product, interleaved RoPE, GQA attention over the cache rows
``r < min(pos, read_len)`` jointly with the token's own key, the int8
``wo`` product and residual, RMSNorm and the int8 SwiGLU FFN.  Then, when
the config ties the head to the embeddings, the final norm and the tied
int8 head give (B, V) logits; with an untied head there is no head phase
and the logits are None (the caller applies ``dual_ar.lm_logits`` to the
hidden state), as in the JAX kernel without a prepared head.

Numerics are the Pallas kernel's, not the XLA path's: every int8 product
rounds its activation to bf16 and accumulates in f32 before the
per-output-channel scale; the stack carries its residual in f32; the cache
is read as f32.  The cache is read-only: the token's roped key and value
come back as ``new_k``/``new_v`` for the caller to write at ``pos``.

``slow_stack_step`` launches the CUDA kernel (``csrc/slow_stack.cu``: one
cooperative launch per call, phases separated by grid-wide barriers, the
cache's attention split over the grid in fixed chunks) for CUDA tensors and
runs ``slow_stack_step_plain`` for CPU tensors only.  The weights are
checked and converted once per parameter set.  Both take an optional
``skip`` flag, a 0-dim bool tensor on the device: when it is set the kernel
returns at once and every output is zeros in both versions.

``supports`` is the engine's gate: the configs, parameters and batches the
kernel takes.  A config it refuses (float weights, attention biases or
qk-norm, B above 16) runs ``dual_ar.slow_forward`` instead.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from fish_tts_tpu_torch.config import DualARConfig
from fish_tts_tpu_torch.ops import kernels
from fish_tts_tpu_torch.utils.quantize import is_quantized

Params = dict[str, Any]

NEG = -1e30  # the Pallas kernel's mask constant
MAX_BATCH = 16

BLOCKS_PER_SM = 4  # 2048 threads per SM over 512 per block: the most the grid can hold
CHUNK = 64         # csrc/slow_stack.cu kChunk: cache rows per attention task

launches = 0  # kernel launches with the tied head, for showing that a run went through it
headless_launches = 0  # the same for the head-less variant (an untied head)
# When set to a CUDA int64 tensor (blocks >= the grid, stamps), each block of
# the kernel writes the global timer (ns) at its start and at its arrival at
# and departure from every grid-wide barrier, in order.
phase_clock: torch.Tensor | None = None


_MATRICES = ("wqkv", "wo", "w1", "w3", "w2")
_CACHE_DTYPES = (torch.bfloat16, torch.float32)


def _cache_row_ok(head_dim: int, dtype: torch.dtype) -> bool:
    """A cache row is read 16 bytes a lane, a power of two of lanes per row."""
    row_bytes = head_dim * (torch.finfo(dtype).bits // 8)
    return row_bytes % 16 == 0 and 32 % (row_bytes // 16) == 0


def supports(cfg: DualARConfig, params: Params, batch: int) -> bool:
    """Whether the kernel takes this config, parameter set and batch: int8
    layer matrices (and a quantized embedding table for a tied head), no
    attention biases or qk-norm, widths within the kernel's limits and a
    cache (the parameters' dtype) it reads."""
    layers = params.get("layers", {})
    return (
        1 <= batch <= MAX_BATCH
        and all(is_quantized(layers.get(k)) for k in _MATRICES)
        and (not cfg.tie_word_embeddings or is_quantized(params.get("embeddings")))
        and not (cfg.attention_qkv_bias or cfg.attention_o_bias or cfg.attention_qk_norm)
        and kernels.block_dims_error(cfg.dim, cfg.n_head, cfg.n_local_heads, cfg.head_dim,
                                     cfg.intermediate_size) is None
        and params["norm"].dtype in _CACHE_DTYPES
        and _cache_row_ok(cfg.head_dim, params["norm"].dtype)
    )


def qdot(x: torch.Tensor, w: Params) -> torch.Tensor:
    """``bf16(x) @ W^T * s`` with f32 accumulation; W int8 (out, in), s
    (out, 1).  bf16 x int8 products are exact in f32."""
    xb = x.to(torch.bfloat16).float()
    return (xb @ w["q"].float().transpose(0, 1)) * w["s"][:, 0].float()


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm entirely in f32, as inside the kernels."""
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w.float()


def rope_rows(x: torch.Tensor, pairs: torch.Tensor) -> torch.Tensor:
    """Rotate interleaved pairs of ``x`` (B, n_heads * Dh) by per-row
    (cos, sin) tables ``pairs`` (B, Dh/2, 2), applied in f32."""
    B = x.shape[0]
    half = pairs.shape[1]
    xp = x.reshape(B, -1, half, 2)
    c = pairs[:, None, :, 0].float()
    s = pairs[:, None, :, 1].float()
    x0, x1 = xp[..., 0], xp[..., 1]
    return torch.stack([x0 * c - x1 * s, x1 * c + x0 * s], dim=-1).reshape(x.shape)


def layer(stack: Params, i: int) -> Params:
    """Layer ``i`` of a stacked (L, ...) weight tree."""
    return {k: ({"q": v["q"][i], "s": v["s"][i]} if isinstance(v, dict) else v[i])
            for k, v in stack.items()}


def block_plain(lp: Params, x: torch.Tensor, q_pairs: torch.Tensor, k_cache, v_cache,
                n_live: torch.Tensor, *, n_head: int, n_kv: int, head_dim: int,
                eps: float, dot=qdot):
    """One decode block for B streams, the kernels' numerics; ``dot`` is the
    int8 product (:func:`qdot`, or the fast decoder's ``s8dot``).

    x (B, D) f32; ``q_pairs`` (B, Dh/2, 2) the RoPE rows of this token;
    k/v_cache (B, Hkv, R, Dh); ``n_live`` (B,) cache rows each stream
    attends (rows at and beyond it are masked).  Returns (x, k (B, Hkv, Dh),
    v (B, Hkv, Dh)) with k roped.
    """
    B = x.shape[0]
    G = n_head // n_kv
    q_size, kv_size = n_head * head_dim, n_kv * head_dim
    qkv = dot(rms(x, lp["attention_norm"], eps), lp["wqkv"])
    q = rope_rows(qkv[:, :q_size], q_pairs).reshape(B, n_kv, G, head_dim)
    k = rope_rows(qkv[:, q_size:q_size + kv_size], q_pairs).reshape(B, n_kv, head_dim)
    v = qkv[:, q_size + kv_size:].reshape(B, n_kv, head_dim)
    scale = 1.0 / math.sqrt(head_dim)
    kc, vc = k_cache.float(), v_cache.float()
    s_cache = torch.einsum("bhgd,bhrd->bhgr", q, kc) * scale
    live = torch.arange(kc.shape[2], device=x.device)[None, :] < n_live[:, None]
    s_cache = torch.where(live[:, None, None, :], s_cache,
                          torch.full_like(s_cache, NEG))
    s_self = torch.einsum("bhgd,bhd->bhg", q, k)[..., None] * scale
    p = torch.softmax(torch.cat([s_cache, s_self], dim=-1), dim=-1)
    o = torch.einsum("bhgr,bhrd->bhgd", p[..., :-1], vc) + p[..., -1:] * v[:, :, None]
    x = x + dot(o.reshape(B, q_size), lp["wo"])
    f = rms(x, lp["ffn_norm"], eps)
    gate = dot(f, lp["w1"])
    x = x + dot(gate * torch.sigmoid(gate) * dot(f, lp["w3"]), lp["w2"])
    return x, k, v


def slow_stack_step_plain(params: Params, cfg: DualARConfig, rope_slow: torch.Tensor,
                          x: torch.Tensor, kv_cache: Params, pos: torch.Tensor, *,
                          read_len: int, skip: torch.Tensor | None = None):
    """Plain PyTorch version of :func:`slow_stack_step` (logits None for an
    untied head)."""
    B = x.shape[0]
    L = cfg.n_layer
    layers = params["layers"]
    pairs = rope_slow[pos.long()]  # (B, Dh/2, 2)
    n_live = torch.clamp(pos.long(), max=read_len)
    h = x.float()
    new_k, new_v = [], []
    for i in range(L):
        h, k, v = block_plain(
            layer(layers, i), h, pairs,
            kv_cache["k"][i, :, :, :read_len], kv_cache["v"][i, :, :, :read_len], n_live,
            n_head=cfg.n_head, n_kv=cfg.n_local_heads, head_dim=cfg.head_dim,
            eps=cfg.norm_eps)
        new_k.append(k[:, :, None])
        new_v.append(v[:, :, None])
    logits = None
    if cfg.tie_word_embeddings:
        logits = qdot(rms(h, params["norm"], cfg.norm_eps), params["embeddings"])
    out = (h[:, None], torch.stack(new_k), torch.stack(new_v), logits)
    if skip is None:
        return out
    return tuple(None if t is None else torch.where(skip, 0.0, t) for t in out)


# The weights of the last parameter set the kernel saw, checked and in the
# kernel's types: (id(params), cfg, whether it has the head, the tensors
# they came from, prepared).
_prepared: tuple | None = None
# One scratch buffer per (device, B, read_len, widths).
_scratch: dict[tuple, torch.Tensor] = {}


def _param_leaves(params: Params, rope_slow: torch.Tensor, with_head: bool) -> tuple:
    lw = params["layers"]
    head = ((params["norm"], params["embeddings"]["q"], params["embeddings"]["s"])
            if with_head else ())
    return (rope_slow, lw["attention_norm"], lw["ffn_norm"],
            *(lw[k][part] for k in _MATRICES for part in ("q", "s")), *head)


def _prepare(params: Params, cfg: DualARConfig, rope_slow: torch.Tensor) -> list:
    """The weight pointers of the kernel call in their order (the final norm
    and the head None without a tied head), checked once per parameter set:
    again only when ``params`` is another dict, the head changes, or it
    holds another tensor than at the last call."""
    global _prepared
    with_head = cfg.tie_word_embeddings
    leaves = _param_leaves(params, rope_slow, with_head)
    if (_prepared is not None and _prepared[:3] == (id(params), cfg, with_head)
            and len(_prepared[3]) == len(leaves)
            and all(a is b for a, b in zip(_prepared[3], leaves))):
        return _prepared[4]
    L, D, H, Hkv, Dh = cfg.n_layer, cfg.dim, cfg.n_head, cfg.n_local_heads, cfg.head_dim
    I = cfg.intermediate_size
    q_size, kv_size = H * Dh, Hkv * Dh
    kernels.check_block_dims("slow_stack_step", D, H, Hkv, Dh, I)
    lw = params["layers"]
    attn_norm = lw["attention_norm"].float().contiguous()
    ffn_norm = lw["ffn_norm"].float().contiguous()
    checks = [
        ("rope_slow", rope_slow, torch.bfloat16, (rope_slow.shape[0], Dh // 2, 2)),
        ("attention_norm", attn_norm, torch.float32, (L, D)),
        ("ffn_norm", ffn_norm, torch.float32, (L, D)),
    ]
    head: list = [None, None, None]
    if with_head:
        emb = params["embeddings"]
        V = emb["q"].shape[0]
        head = [params["norm"].float().contiguous(), emb["q"], emb["s"]]
        checks += [("norm", head[0], torch.float32, (D,)),
                   ("embeddings.q", emb["q"], torch.int8, (V, D)),
                   ("embeddings.s", emb["s"], torch.float32, (V, 1))]
    shapes = {"wqkv": (q_size + 2 * kv_size, D), "wo": (D, q_size),
              "w1": (I, D), "w3": (I, D), "w2": (D, I)}
    for k, (n_out, n_in) in shapes.items():
        checks.append((f"layers.{k}.q", lw[k]["q"], torch.int8, (L, n_out, n_in)))
        checks.append((f"layers.{k}.s", lw[k]["s"], torch.float32, (L, n_out, 1)))
    for name, t, dtype, shape in checks:
        kernels.require_cuda(name, t, dtype, shape)
        if t.data_ptr() % 16:  # the kernel's bulk copies move 16-byte-aligned spans
            raise ValueError(f"slow_stack_step: {name} is not 16-byte aligned")
    weights = [rope_slow, attn_norm, ffn_norm,
               *(lw[k][part] for k in _MATRICES for part in ("q", "s")), *head]
    _prepared = (id(params), cfg, with_head, leaves, weights)
    return weights


def slow_stack_step(params: Params, cfg: DualARConfig, rope_slow: torch.Tensor,
                    x: torch.Tensor, kv_cache: Params, pos: torch.Tensor, *,
                    read_len: int, skip: torch.Tensor | None = None):
    """Fused one-token slow forward over B independent streams.

    x (B, D) embedded tokens; kv_cache {"k", "v"} (L, B, Hkv, S, Dh); pos
    (B,) int32; ``read_len`` bounds the cache rows read.  Returns (hidden
    (B, 1, D) f32 before the final norm, new_k (L, B, Hkv, 1, Dh) f32,
    new_v, logits (B, V) f32, or None for an untied head).

    On CUDA tensors this is one cooperative launch of every block the card
    holds; it raises if the card (or an MPS limit) refuses such a launch.
    """
    if cfg.attention_qkv_bias or cfg.attention_o_bias or cfg.attention_qk_norm:
        raise ValueError("slow_stack_step: the kernel and its plain version have no "
                         "attention biases or qk-norm")
    if x.device.type == "cpu":
        return slow_stack_step_plain(params, cfg, rope_slow, x, kv_cache, pos,
                                     read_len=read_len, skip=skip)
    global launches, headless_launches
    B, D = x.shape
    L, H, Hkv, Dh = cfg.n_layer, cfg.n_head, cfg.n_local_heads, cfg.head_dim
    I = cfg.intermediate_size
    if not 1 <= B <= MAX_BATCH:
        raise ValueError(f"slow_stack_step: batch {B} outside 1..{MAX_BATCH}")
    weights = _prepare(params, cfg, rope_slow)
    kc, vc = kv_cache["k"], kv_cache["v"]
    S = kc.shape[3]
    if kc.dtype not in _CACHE_DTYPES:
        raise ValueError(f"slow_stack_step: cache dtype {kc.dtype} not supported")
    if not _cache_row_ok(Dh, kc.dtype):
        raise ValueError(f"slow_stack_step: head_dim {Dh} must be a power of two, "
                         f"at least {16 // kc.element_size()}")
    if not 0 < read_len <= S:
        raise ValueError(f"slow_stack_step: read_len {read_len} outside 1..{S}")
    if rope_slow.shape[0] < S:
        raise ValueError("slow_stack_step: RoPE table shorter than the cache")
    if x.dtype != torch.float32 or not x.is_contiguous() or x.data_ptr() % 16:
        x = x.to(torch.float32, copy=True)  # read 16 bytes at a time
    for name, t, dtype, shape in (("x", x, torch.float32, (B, D)),
                                  ("pos", pos, torch.int32, (B,)),
                                  ("kv_cache.k", kc, kc.dtype, (L, B, Hkv, S, Dh)),
                                  ("kv_cache.v", vc, kc.dtype, (L, B, Hkv, S, Dh))):
        kernels.require_cuda(name, t, dtype, shape)
    if kc.data_ptr() % 16 or vc.data_ptr() % 16:
        raise ValueError("slow_stack_step: the cache is not 16-byte aligned")
    if skip is not None:
        kernels.require_cuda("skip", skip, torch.bool, ())

    dev = x.device
    V = weights[-2].shape[0] if cfg.tie_word_embeddings else 0
    f32 = dict(dtype=torch.float32, device=dev)
    # the outputs are views of one allocation, each part 16-byte aligned; a
    # skipped call writes nothing, so with a flag they are allocated zeroed
    n_kv = L * B * Hkv * Dh
    out = (torch.empty if skip is None else torch.zeros)((B * D + 2 * n_kv + B * V,), **f32)
    hidden, new_k, new_v, logits = torch.split(out, (B * D, n_kv, n_kv, B * V))
    hidden = hidden.view(B, D)
    new_k = new_k.view(L, B, Hkv, 1, Dh)
    new_v = new_v.view(L, B, Hkv, 1, Dh)
    logits = logits.view(B, V) if V else None
    # one scratch buffer, carved by the kernel's entry: qkv, SwiGLU hidden,
    # attention output, the attention partials (max, denominator, weighted
    # sums per cache chunk) and the count of finished attention tasks per
    # (layer, stream, KV head); each part rounded up to 4 floats
    recs = B * Hkv * -(-read_len // CHUNK) * (H // Hkv)
    parts = (B * (H + 2 * Hkv) * Dh, B * I, B * H * Dh, recs, recs, recs * Dh, L * B * Hkv)
    n_scratch = sum(-(-n // 4) * 4 for n in parts)
    key = (dev, B, read_len, L, H, Hkv, Dh, I)
    scratch = _scratch.get(key)
    if scratch is None:
        scratch = _scratch[key] = torch.empty((n_scratch,), **f32)
    clock = phase_clock
    if clock is not None:
        kernels.require_cuda("phase_clock", clock, torch.int64)
        if clock.dim() != 2 or clock.shape[0] < BLOCKS_PER_SM * kernels.num_sms(dev):
            raise ValueError("phase_clock: expected (blocks, stamps) with a row per block")
    ptrs = [x, pos, weights[0], kc, vc, new_k, new_v, *weights[1:], hidden, logits, scratch,
            clock, skip]
    dims = [B, L, D, H, Hkv, Dh, I, V, S, read_len, int(kc.dtype == torch.bfloat16),
            0 if clock is None else clock.shape[1], n_scratch]
    kernels.launch("fts_slow_stack_step", ptrs, dims, eps=cfg.norm_eps)
    if V:
        launches += 1
    else:
        headless_launches += 1
    return hidden[:, None], new_k, new_v, logits
