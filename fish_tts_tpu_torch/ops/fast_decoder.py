"""Fast-codebook decoder: the per-frame loop over the codebook positions
(kernel 3).

Port of ``fish_tts_tpu/ops/fast_decoder.py::fast_decode_frame`` with its
dequant modes (``DEQUANT_MODES``).  Position 0 runs the fast layers on the
projected slow hidden state and only fills the per-frame K/V cache.  Each
position cb = 1..K-1 embeds the previous code (int8 row x row scale), runs
the layers with causal attention over the positions so far, applies
``fast_norm`` and the int8 head over the first Vr columns of
``fast_output``, then samples: the repetition penalty over the stream's
window row, the sort-free exact top-p (i is kept iff
``sum(p_j : l_j > l_i) + p_i <= top_p``, or i is the argmax, or
``top_p >= 1``), the temperature clamped at 1e-5, and the Gumbel argmax
with noise drawn by the caller.

Numerics are the Pallas kernel's.  ``"value"`` (the default) and
``"scratch"`` (equal to it to the bit in the JAX package, so it runs the
same code): activations round to bf16 before each int8 product,
accumulation and the per-frame K/V cache are f32.  ``"s8"``: each product's
activation row is quantized to int8 by its own absmax (:func:`s8dot`) and
the s8 x s8 products sum exactly in integers; the embedding stays exact.

``fast_decode_frame`` launches the CUDA kernel (``csrc/fast_decoder.cu``:
one cooperative launch per frame, phases separated by grid-wide barriers;
the ``"s8"`` mode its own instantiation, counted in ``launches_s8``; at
B >= 2 the ``"value"`` mode spreads each position's attention over the
grid, one (stream, query head) per warp, counted in ``launches_spread``)
for CUDA tensors and runs ``fast_decode_frame_plain`` for CPU tensors only.
The weights are checked and converted once per parameter set, and the
kernel's scratch is allocated once per shape.  Both take an optional
``skip`` flag, a 0-dim bool tensor on the device: when it is set the kernel
returns at once and the outputs are zeros in both versions.

``supports`` is the engine's gate.  Unlike the JAX kernel's gate, which
never asks, it refuses a fast stack with attention biases or qk-norm: the
kernel applies neither, so such a config runs the plain loop over
``dual_ar.fast_step``, the reference's correct route.
"""

from __future__ import annotations

from typing import Any

import torch

from fish_tts_tpu_torch.config import DualARConfig
from fish_tts_tpu_torch.ops import kernels
from fish_tts_tpu_torch.ops.slow_stack import block_plain, layer, qdot, rms
from fish_tts_tpu_torch.utils.quantize import is_quantized

Params = dict[str, Any]

NEG = -1e30  # the Pallas kernel's mask constant
MAX_BATCH = 16
MAX_WINDOW = 64    # csrc/fast_decoder.cu kMaxWindow
MAX_POS = 12       # csrc/fast_decoder.cu kMaxPos: codebook positions per frame
MAX_HEAD_DIM = 64  # csrc/fast_decoder.cu kMaxFastHeadDim: one RoPE pair per lane
BLOCKS_PER_SM = 4  # 2048 threads per SM over 512 per block: the most the grid can hold

launches = 0  # kernel launches, for showing that a run went through it
launches_s8 = 0  # the same for the "s8" variant
launches_spread = 0  # the "value" launches at B >= 2, whose attention is spread over the grid

# The Pallas kernel's ways of feeding its int8 weights to the products (JAX
# fast_decoder.py:98): "scratch" and "value" dequantize the weights exactly
# (equal to the bit), "s8" quantizes the activations instead.
DEQUANT_MODES = ("scratch", "value", "s8")
DEFAULT_DEQUANT = "value"
# When set to a CUDA int64 tensor (blocks >= the grid, stamps), each block of
# the kernel writes the global timer (ns) at its start and at its arrival at
# and departure from every grid-wide barrier, in order.
phase_clock: torch.Tensor | None = None
# When set to CUDA tensors (rows (T, B, s8_trace_width) int8, scales (T, B)
# f32), block 0 of the "s8" variant copies each activation row it quantizes
# and its scales there, in the order of ``s8_trace_layout`` (at most T rows).
s8_trace: tuple[torch.Tensor, torch.Tensor] | None = None
S8_KINDS = ("wqkv", "wo", "w13", "w2")  # the quantized inputs of one layer, in order


_MATRICES = ("wqkv", "wo", "w1", "w3", "w2")


def resolve_dequant(dequant: str | None) -> str:
    """The dequant mode, ``DEFAULT_DEQUANT`` for None; raises ValueError on
    an unknown one, as the JAX entry does."""
    dequant = dequant or DEFAULT_DEQUANT
    if dequant not in DEQUANT_MODES:
        raise ValueError(f"dequant must be one of {DEQUANT_MODES}")
    return dequant


def supports(cfg: DualARConfig, params: Params, batch: int, window: int,
             dequant: str | None = None) -> bool:
    """Whether the kernel takes this config, parameter set, batch and penalty
    window: int8 fast layers, embeddings and head, no attention biases or
    qk-norm in the fast stack, widths within the kernel's limits.  Every
    dequant mode has the same limits; an unknown one raises."""
    resolve_dequant(dequant)
    fl = params.get("fast_layers", {})
    return (
        1 <= batch <= MAX_BATCH
        and 1 <= window <= MAX_WINDOW
        and all(is_quantized(fl.get(k)) for k in _MATRICES)
        and is_quantized(params.get("fast_embeddings"))
        and is_quantized(params.get("fast_output"))
        and not (cfg.fast_attention_qkv_bias or cfg.fast_attention_o_bias
                 or cfg.fast_attention_qk_norm)
        and kernels.block_dims_error(cfg.fast_dim, cfg.fast_n_head, cfg.fast_n_local_heads,
                                     cfg.fast_head_dim, cfg.fast_intermediate_size) is None
        and cfg.fast_head_dim <= MAX_HEAD_DIM
        and 2 <= cfg.num_codebooks <= MAX_POS
        and params["fast_output"]["q"].shape[0] >= cfg.residual_codebook_size
        and params["norm"].dtype in (torch.float32, torch.bfloat16)
    )


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


def s8_trace_width(cfg: DualARConfig) -> int:
    """The widest input the fast layers quantize: a row of ``s8_trace``."""
    return max(cfg.fast_dim, cfg.fast_n_head * cfg.fast_head_dim, cfg.fast_intermediate_size)


def s8_trace_layout(cfg: DualARConfig, kernel: bool = True) -> list[tuple[int, int, str]]:
    """(position, layer or -1, kind) of each activation row a frame quantizes
    in the ``"s8"`` mode, in order: S8_KINDS per layer, then the head
    (``"head"``) at positions >= 1.  The kernel (``kernel``) stops position
    0's last layer after its first row, whose output it discards; the plain
    version runs that layer whole."""
    L = cfg.n_fast_layer
    out = []
    for pos in range(cfg.num_codebooks):
        for i in range(L):
            kinds = S8_KINDS[:1] if kernel and pos == 0 and i == L - 1 else S8_KINDS
            out += [(pos, i, kind) for kind in kinds]
        if pos > 0:
            out.append((pos, -1, "head"))
    return out


def s8_scaled(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``"s8"`` mode's quantization before its rounding: (x / sc, sc)
    with ``sc = max(amax, 1e-30) / 127`` over the f32 row."""
    x = x.float()
    sc = torch.clamp(x.abs().amax(dim=-1, keepdim=True), min=1e-30) / 127
    return x / sc, sc


def s8dot(x: torch.Tensor, w: Params) -> torch.Tensor:
    """The ``"s8"`` mode's product (JAX ``s8dot``, fast_decoder.py:244-252,
    with the weight scale after it): the f32 row quantized by its absmax
    (:func:`s8_scaled`), ``xq = round_half_even(x / sc)``, the s8 x s8 sums
    (exact in float64), then ``(acc * sc) * s``.  W int8 (out, in), s
    (out, 1)."""
    q, sc = s8_scaled(x)
    xq = torch.round(q).to(torch.int8)
    acc = (xq.double() @ w["q"].double().transpose(0, 1)).float()
    return (acc * sc) * w["s"][:, 0].float()


def fast_decode_frame_plain(params: Params, cfg: DualARConfig, rope_fast, h_fast, a0,
                            prev_rows, gumbel, temperature, top_p, repetition_penalty, *,
                            window: int, skip: torch.Tensor | None = None,
                            dequant: str | None = None):
    """Plain PyTorch version of :func:`fast_decode_frame`."""
    dot = s8dot if resolve_dequant(dequant) == "s8" else qdot
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
                                  n_head=H, n_kv=Hkv, head_dim=Dh, eps=cfg.norm_eps, dot=dot)
            kc[:, :, pos] = k
            vc[:, :, pos] = v
        if pos == 0:  # position 0 only fills the cache
            continue
        logits = dot(rms(x, params["fast_norm"], cfg.norm_eps), head)
        logits = penalize(logits, prev_rows[:, pos - 1], rep)
        keep = top_p_pairwise_keep(logits, tp)
        masked = torch.where(keep, logits, torch.full_like(logits, NEG))
        scaled = masked / torch.clamp(temp, min=1e-5)
        code = torch.argmax(scaled + gumbel[:, pos - 1].float(), dim=-1)
        codes.append(code)
        logits_out.append(logits)
    codes, logits = torch.stack(codes, dim=1).to(torch.int32), torch.stack(logits_out, dim=1)
    if skip is None:
        return codes, logits
    return torch.where(skip, 0, codes), torch.where(skip, 0.0, logits)


# The weights of the last parameter set the kernel saw, checked and in the
# kernel's types: (id(params), cfg, the tensors they came from, prepared).
_prepared: tuple | None = None
# One scratch buffer per (device, B, widths).
_scratch: dict[tuple, torch.Tensor] = {}


def _param_leaves(params: Params, rope_fast: torch.Tensor) -> tuple:
    fl = params["fast_layers"]
    return (rope_fast, fl["attention_norm"], fl["ffn_norm"], params["fast_norm"],
            *(fl[k][part] for k in _MATRICES for part in ("q", "s")),
            params["fast_output"]["q"], params["fast_output"]["s"],
            params["fast_embeddings"]["q"], params["fast_embeddings"]["s"])


def _prepare(params: Params, cfg: DualARConfig, rope_fast: torch.Tensor) -> list:
    """The weight pointers of the kernel call in their order, checked once per
    parameter set: again only when ``params`` is another dict or holds
    another tensor than at the last call."""
    global _prepared
    leaves = _param_leaves(params, rope_fast)
    if (_prepared is not None and _prepared[0] == id(params) and _prepared[1] == cfg
            and all(a is b for a, b in zip(_prepared[2], leaves))):
        return _prepared[3]
    K, Vr, L, D = cfg.num_codebooks, cfg.residual_codebook_size, cfg.n_fast_layer, cfg.fast_dim
    H, Hkv, Dh = cfg.fast_n_head, cfg.fast_n_local_heads, cfg.fast_head_dim
    I = cfg.fast_intermediate_size
    q_size, kv_size = H * Dh, Hkv * Dh
    kernels.check_block_dims("fast_decode_frame", D, H, Hkv, Dh, I)
    if Dh > MAX_HEAD_DIM or not 2 <= K <= MAX_POS:
        raise ValueError(f"fast_decode_frame: head_dim {Dh} (<= {MAX_HEAD_DIM}) or "
                         f"{K} codebooks (2..{MAX_POS}) not supported")
    fl = params["fast_layers"]
    head = params["fast_output"]
    emb = params["fast_embeddings"]
    C = emb["q"].shape[0]
    attn_norm = fl["attention_norm"].float().contiguous()
    ffn_norm = fl["ffn_norm"].float().contiguous()
    fast_norm = params["fast_norm"].float().contiguous()
    checks = [
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
        if t.data_ptr() % 16:  # the kernel's bulk copies move 16-byte-aligned spans
            raise ValueError(f"fast_decode_frame: {name} is not 16-byte aligned")
    if head["q"].shape[0] < Vr:
        raise ValueError("fast_decode_frame: fast_output has fewer than Vr rows")
    weights = [rope_fast, attn_norm, ffn_norm,
               *(fl[k][part] for k in _MATRICES for part in ("q", "s")),
               fast_norm, head["q"], head["s"], emb["q"], emb["s"]]
    _prepared = (id(params), cfg, leaves, weights)
    return weights


def fast_decode_frame(params: Params, cfg: DualARConfig, rope_fast, h_fast, a0, prev_rows,
                      gumbel, temperature, top_p, repetition_penalty, *, window: int,
                      skip: torch.Tensor | None = None, dequant: str | None = None):
    """Run the per-frame codebook loop for B <= 16 streams.

    h_fast (B, D) projected slow hidden (f32 or bf16); a0 (B,) first code;
    prev_rows (B, K-1, W) int32 penalty windows; gumbel (B, K-1, Vr) f32;
    sampling parameters scalar or (B, 1); ``dequant`` one of
    ``DEQUANT_MODES`` (None: ``DEFAULT_DEQUANT``).  Returns (codes (B, K-1)
    int32, penalized logits (B, K-1, Vr) f32).

    On CUDA tensors this is one cooperative launch of every block the card
    holds; it raises if the card (or an MPS limit) refuses such a launch.
    """
    if cfg.fast_attention_qkv_bias or cfg.fast_attention_o_bias or cfg.fast_attention_qk_norm:
        raise ValueError("fast_decode_frame: the kernel and its plain version have no "
                         "attention biases or qk-norm")
    s8 = resolve_dequant(dequant) == "s8"
    if h_fast.device.type == "cpu":
        return fast_decode_frame_plain(params, cfg, rope_fast, h_fast, a0, prev_rows,
                                       gumbel, temperature, top_p, repetition_penalty,
                                       window=window, skip=skip, dequant=dequant)
    global launches, launches_s8, launches_spread
    B, D = h_fast.shape
    K, Vr, L = cfg.num_codebooks, cfg.residual_codebook_size, cfg.n_fast_layer
    H, Hkv, Dh = cfg.fast_n_head, cfg.fast_n_local_heads, cfg.fast_head_dim
    I = cfg.fast_intermediate_size
    W = window
    if not 1 <= B <= MAX_BATCH:
        raise ValueError(f"fast_decode_frame: batch {B} outside 1..{MAX_BATCH}")
    if not 1 <= W <= MAX_WINDOW:
        raise ValueError(f"fast_decode_frame: window {W} outside 1..{MAX_WINDOW}")
    weights = _prepare(params, cfg, rope_fast)
    h_fast = h_fast.contiguous()
    dev = h_fast.device
    temp = column(temperature, B, dev)
    tp = column(top_p, B, dev)
    rep = column(repetition_penalty, B, dev)
    for name, t, dtype, shape in (
            ("h_fast", h_fast, h_fast.dtype, (B, cfg.fast_dim)),
            ("a0", a0, torch.int32, (B,)),
            ("prev_rows", prev_rows, torch.int32, (B, K - 1, W)),
            ("gumbel", gumbel, torch.float32, (B, K - 1, Vr))):
        kernels.require_cuda(name, t, dtype, shape)
    if h_fast.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fast_decode_frame: h_fast dtype {h_fast.dtype} not supported")
    if h_fast.data_ptr() % 16:  # read 16 bytes at a time
        h_fast = h_fast.clone()
    if skip is not None:
        kernels.require_cuda("skip", skip, torch.bool, ())

    # a skipped call writes nothing, so with a flag the outputs are allocated zeroed
    alloc = torch.empty if skip is None else torch.zeros
    codes = alloc((B, K - 1), dtype=torch.int32, device=dev)
    logits = alloc((B, K - 1, Vr), dtype=torch.float32, device=dev)
    cand_cap = BLOCKS_PER_SM * kernels.num_sms(dev) * B
    # one scratch buffer, carved by the kernel's entry: residual stream,
    # qkv, SwiGLU hidden, per-frame K and V caches, head logits, each
    # block's best score and lane, the "s8" variant's per-block maxima of
    # the SwiGLU rows, and the spread attention's bf16 output (B, H * Dh, two
    # to a float); each part rounded up to 4 floats
    parts = (B * D, B * (H + 2 * Hkv) * Dh, B * I, L * B * Hkv * K * Dh,
             L * B * Hkv * K * Dh, B * Vr, cand_cap, cand_cap, cand_cap, B * H * Dh // 2)
    n_scratch = sum(-(-n // 4) * 4 for n in parts)
    key = (dev, B, K, L, D, H, Hkv, Dh, I, Vr)
    scratch = _scratch.get(key)
    if scratch is None:
        scratch = _scratch[key] = torch.empty((n_scratch,), dtype=torch.float32, device=dev)
    clock = phase_clock
    if clock is not None:
        kernels.require_cuda("phase_clock", clock, torch.int64)
        if clock.dim() != 2 or clock.shape[0] < cand_cap // B:
            raise ValueError("phase_clock: expected (blocks, stamps) with a row per block")
    trace = s8_trace if s8 and s8_trace is not None else (None, None)
    if trace[0] is not None:
        kernels.require_cuda("s8_trace rows", trace[0], torch.int8)
        kernels.require_cuda("s8_trace scales", trace[1], torch.float32, trace[0].shape[:2])
        if trace[0].dim() != 3 or trace[0].shape[1:] != (B, s8_trace_width(cfg)):
            raise ValueError(f"s8_trace: expected rows (T, {B}, {s8_trace_width(cfg)})")
        if trace[0].data_ptr() % 16:  # block 0 copies the rows 16 bytes at a time
            raise ValueError("s8_trace: rows are not 16-byte aligned")
    ptrs = [h_fast, a0, prev_rows, gumbel, temp, tp, rep, *weights, codes, logits, scratch,
            clock, skip, *trace]
    dims = [B, K, L, D, H, Hkv, Dh, I, Vr, W, int(h_fast.dtype == torch.bfloat16), cand_cap,
            0 if clock is None else clock.shape[1], n_scratch, int(s8),
            0 if trace[0] is None else trace[0].shape[0]]
    kernels.launch("fts_fast_decode_frame", ptrs, dims, eps=cfg.norm_eps)
    if s8:
        launches_s8 += 1
    else:
        launches += 1
        launches_spread += int(B >= 2)
    return codes, logits
