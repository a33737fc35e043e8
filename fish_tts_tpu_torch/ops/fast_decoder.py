"""Fast-codebook decoder: the per-frame loop over the codebook positions
(kernel 3).

Port of ``fish_tts_tpu/ops/fast_decoder.py::fast_decode_frame`` in its
default ``"value"`` dequant mode.  Position 0 runs the fast layers on the
projected slow hidden state and only fills the per-frame K/V cache.  Each
position cb = 1..K-1 embeds the previous code (int8 row x row scale), runs
the layers with causal attention over the positions so far, applies
``fast_norm`` and the int8 head over the first Vr columns of
``fast_output``, then samples: the repetition penalty over the stream's
window row, the sort-free exact top-p (i is kept iff
``sum(p_j : l_j > l_i) + p_i <= top_p``, or i is the argmax, or
``top_p >= 1``), the temperature clamped at 1e-5, and the Gumbel argmax
with noise drawn by the caller.

Numerics are the Pallas kernel's: activations round to bf16 before each
int8 product, accumulation and the per-frame K/V cache are f32.

``fast_decode_frame`` launches the CUDA kernels (``csrc/fast_decoder.cu``)
for CUDA tensors and runs ``fast_decode_frame_plain`` for CPU tensors only.
"""

from __future__ import annotations

from typing import Any

import torch

from fish_tts_tpu_torch.config import DualARConfig
from fish_tts_tpu_torch.ops import kernels
from fish_tts_tpu_torch.ops.slow_stack import block_plain, layer, qdot, rms

Params = dict[str, Any]

NEG = -1e30  # the Pallas kernel's mask constant
MAX_BATCH = 16
MAX_WINDOW = 64  # csrc/fast_decoder.cu kMaxWindow

launches = 0  # kernel launches, for showing that a run went through it


def column(x, batch: int, device) -> torch.Tensor:
    """Scalar or per-stream sampling parameter -> (B, 1) f32 column."""
    t = torch.as_tensor(x, dtype=torch.float32, device=device).reshape(-1, 1)
    return t.expand(batch, 1).contiguous()


def penalize(logits: torch.Tensor, window: torch.Tensor, rep: torch.Tensor) -> torch.Tensor:
    """Repetition penalty: lanes named in ``window`` (B, W) have positive
    logits divided by ``rep`` (B, 1) and negative ones multiplied."""
    lanes = torch.arange(logits.shape[-1], device=logits.device)
    hit = (lanes[None, None, :] == window.long()[:, :, None]).any(dim=1)
    return torch.where(hit, torch.where(logits < 0, logits * rep, logits / rep), logits)


def top_p_pairwise_keep(logits: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Sort-free exact nucleus: keep i iff the mass strictly above it plus
    its own is within ``top_p``, or i is the argmax, or ``top_p >= 1``."""
    amax = logits.max(dim=-1, keepdim=True).values
    z = torch.log(torch.exp(logits - amax).sum(dim=-1, keepdim=True)) + amax
    p = torch.exp(logits - z)
    above = torch.where(logits[:, None, :] > logits[:, :, None], p[:, None, :],
                        torch.zeros((), device=logits.device)).sum(dim=-1)
    return (above + p <= top_p) | (logits >= amax) | (top_p >= 1.0)


def fast_decode_frame_plain(params: Params, cfg: DualARConfig, rope_fast, h_fast, a0,
                            prev_rows, gumbel, temperature, top_p, repetition_penalty, *,
                            window: int):
    """Plain PyTorch version of :func:`fast_decode_frame`."""
    B = h_fast.shape[0]
    K, Vr = cfg.num_codebooks, cfg.residual_codebook_size
    H, Hkv, Dh = cfg.fast_n_head, cfg.fast_n_local_heads, cfg.fast_head_dim
    dev = h_fast.device
    temp = column(temperature, B, dev)
    tp = column(top_p, B, dev)
    rep = column(repetition_penalty, B, dev)
    fl = params["fast_layers"]
    emb = params["fast_embeddings"]
    head = {"q": params["fast_output"]["q"][:Vr], "s": params["fast_output"]["s"][:Vr]}
    caches = [(torch.zeros((B, Hkv, K, Dh), device=dev),
               torch.zeros((B, Hkv, K, Dh), device=dev)) for _ in range(cfg.n_fast_layer)]
    code = a0.long()
    codes, logits_out = [], []
    for pos in range(K):
        if pos == 0:
            x = h_fast.float()
        else:
            x = emb["q"][code].float() * emb["s"][code].float()
        pairs = rope_fast[pos].expand(B, -1, -1)
        n_live = torch.full((B,), pos, device=dev)
        for i in range(cfg.n_fast_layer):
            kc, vc = caches[i]
            x, k, v = block_plain(layer(fl, i), x, pairs, kc, vc, n_live,
                                  n_head=H, n_kv=Hkv, head_dim=Dh, eps=cfg.norm_eps)
            kc[:, :, pos] = k
            vc[:, :, pos] = v
        if pos == 0:  # position 0 only fills the cache
            continue
        logits = qdot(rms(x, params["fast_norm"], cfg.norm_eps), head)
        logits = penalize(logits, prev_rows[:, pos - 1], rep)
        keep = top_p_pairwise_keep(logits, tp)
        masked = torch.where(keep, logits, torch.full_like(logits, NEG))
        scaled = masked / torch.clamp(temp, min=1e-5)
        code = torch.argmax(scaled + gumbel[:, pos - 1].float(), dim=-1)
        codes.append(code)
        logits_out.append(logits)
    return (torch.stack(codes, dim=1).to(torch.int32), torch.stack(logits_out, dim=1))


def fast_decode_frame(params: Params, cfg: DualARConfig, rope_fast, h_fast, a0, prev_rows,
                      gumbel, temperature, top_p, repetition_penalty, *, window: int):
    """Run the per-frame codebook loop for B <= 16 streams.

    h_fast (B, D) projected slow hidden; a0 (B,) first code; prev_rows
    (B, K-1, W) int32 penalty windows; gumbel (B, K-1, Vr) f32; sampling
    parameters scalar or (B, 1).  Returns (codes (B, K-1) int32, penalized
    logits (B, K-1, Vr) f32).
    """
    if h_fast.device.type == "cpu":
        return fast_decode_frame_plain(params, cfg, rope_fast, h_fast, a0, prev_rows,
                                       gumbel, temperature, top_p, repetition_penalty,
                                       window=window)
    global launches
    B, D = h_fast.shape
    K, Vr, L = cfg.num_codebooks, cfg.residual_codebook_size, cfg.n_fast_layer
    H, Hkv, Dh = cfg.fast_n_head, cfg.fast_n_local_heads, cfg.fast_head_dim
    I = cfg.fast_intermediate_size
    q_size, kv_size = H * Dh, Hkv * Dh
    W = window
    if not 1 <= B <= MAX_BATCH:
        raise ValueError(f"fast_decode_frame: batch {B} outside 1..{MAX_BATCH}")
    if not 1 <= W <= MAX_WINDOW:
        raise ValueError(f"fast_decode_frame: window {W} outside 1..{MAX_WINDOW}")
    kernels.check_block_dims("fast_decode_frame", D, H, Hkv, Dh, I)
    dev = h_fast.device
    fl = params["fast_layers"]
    head = params["fast_output"]
    emb = params["fast_embeddings"]
    C = emb["q"].shape[0]
    h = h_fast.to(torch.float32).contiguous()
    temp = column(temperature, B, dev)
    tp = column(top_p, B, dev)
    rep = column(repetition_penalty, B, dev)
    attn_norm = fl["attention_norm"].float().contiguous()
    ffn_norm = fl["ffn_norm"].float().contiguous()
    fast_norm = params["fast_norm"].float().contiguous()
    checks = [
        ("h_fast", h, torch.float32, (B, D)),
        ("a0", a0, torch.int32, (B,)),
        ("prev_rows", prev_rows, torch.int32, (B, K - 1, W)),
        ("gumbel", gumbel, torch.float32, (B, K - 1, Vr)),
        ("rope_fast", rope_fast, torch.bfloat16, (K, Dh // 2, 2)),
        ("attention_norm", attn_norm, torch.float32, (L, D)),
        ("ffn_norm", ffn_norm, torch.float32, (L, D)),
        ("fast_norm", fast_norm, torch.float32, (D,)),
        ("fast_output.q", head["q"], torch.int8, (head["q"].shape[0], D)),
        ("fast_output.s", head["s"], torch.float32, (head["q"].shape[0], 1)),
        ("fast_embeddings.q", emb["q"], torch.int8, (C, D)),
        ("fast_embeddings.s", emb["s"], torch.float32, (C, 1)),
    ]
    shapes = {"wqkv": (q_size + 2 * kv_size, D), "wo": (D, q_size),
              "w1": (I, D), "w3": (I, D), "w2": (D, I)}
    for k, (n_out, n_in) in shapes.items():
        checks.append((f"fast_layers.{k}.q", fl[k]["q"], torch.int8, (L, n_out, n_in)))
        checks.append((f"fast_layers.{k}.s", fl[k]["s"], torch.float32, (L, n_out, 1)))
    for name, t, dtype, shape in checks:
        kernels.require_cuda(name, t, dtype, shape)
    if head["q"].shape[0] < Vr:
        raise ValueError("fast_decode_frame: fast_output has fewer than Vr rows")

    f32 = dict(dtype=torch.float32, device=dev)
    codes = torch.empty((B, K - 1), dtype=torch.int32, device=dev)
    logits = torch.empty((B, K - 1, Vr), **f32)
    scratch = [
        torch.empty((B, D), **f32),                       # x
        torch.empty((B, q_size + 2 * kv_size), **f32),    # qkv
        torch.empty((B, q_size), **f32),                  # attention output
        torch.empty((B, I), **f32),                       # SwiGLU hidden
        torch.empty((L, B, Hkv, K, Dh), **f32),           # per-frame K cache
        torch.empty((L, B, Hkv, K, Dh), **f32),           # per-frame V cache
        torch.empty((B, Vr), **f32),                      # head logits
        torch.empty((B,), dtype=torch.int32, device=dev),  # current code
    ]
    ptrs = [h, a0, prev_rows, gumbel, temp, tp, rep, rope_fast, attn_norm, ffn_norm,
            fl["wqkv"]["q"], fl["wqkv"]["s"], fl["wo"]["q"], fl["wo"]["s"],
            fl["w1"]["q"], fl["w1"]["s"], fl["w3"]["q"], fl["w3"]["s"],
            fl["w2"]["q"], fl["w2"]["s"], fast_norm, head["q"], head["s"],
            emb["q"], emb["s"], codes, logits, *scratch]
    dims = [B, K, L, D, H, Hkv, Dh, I, Vr, W]
    kernels.launch("fts_fast_decode_frame", ptrs, dims, eps=cfg.norm_eps)
    launches += 1
    return codes, logits
