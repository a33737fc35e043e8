"""Weight-only int8 quantization, the port's copy of ``utils/quantize.py``.

Symmetric per-channel int8: the scale is ``max|w| / 127`` over the
contraction axis, values round half to even (``torch.round``) and clip to
±127.  The quantized key set is the JAX package's.

Layout: the port stores linear weights as ``(out, in)`` (PyTorch's
``nn.Linear`` convention; ``checkpoint.from_jax_params`` transposes the JAX
package's ``(in, out)``), so every output channel is one contiguous int8
row.  The contraction axis of a layer-stack weight is therefore axis 2, and
its scale has shape ``(L, out, 1)``.
"""

from __future__ import annotations

from typing import Any

import torch

Params = dict[str, Any]

_LAYER_MATMUL_KEYS = ("wqkv", "wo", "w1", "w3", "w2")


def quantize_weight(w: torch.Tensor, axis: int) -> Params:
    """Symmetric per-channel int8 with the scale over ``axis``.
    Returns {"q": int8 same shape, "s": f32 scale broadcastable to w}."""
    wf = w.float()
    amax = wf.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"q": q, "s": scale}


def is_quantized(w) -> bool:
    return isinstance(w, dict) and "q" in w and "s" in w


def qmm(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ W^T`` for a plain ``(out, in)`` or quantized weight: the int8
    rows are upcast to x's dtype and the per-output-channel scale folds
    into the product in f32."""
    if not is_quantized(w):
        return x @ w.transpose(-1, -2)
    out = x @ w["q"].to(x.dtype).transpose(-1, -2)
    return (out.float() * w["s"][..., 0]).to(x.dtype)


def qgather(table, idx: torch.Tensor, out_dtype) -> torch.Tensor:
    """Embedding-row gather from a plain or row-quantized table."""
    if not is_quantized(table):
        return table[idx]
    rows = table["q"][idx].float()
    return (rows * table["s"][idx]).to(out_dtype)


def qhead(h: torch.Tensor, table) -> torch.Tensor:
    """Tied LM head against a (possibly row-quantized) embedding table:
    logits[v] = h . emb[v]."""
    if not is_quantized(table):
        return h @ table.transpose(0, 1)
    logits = h @ table["q"].to(h.dtype).transpose(0, 1)
    return (logits.float() * table["s"][:, 0]).to(h.dtype)


def _quantize_layer_stack(stack: Params) -> Params:
    out = dict(stack)
    for k in _LAYER_MATMUL_KEYS:
        out[k] = quantize_weight(stack[k], axis=2)  # (L, out, in)
    return out


def quantize_lm_params(params: Params) -> Params:
    """Quantize the DualAR decode hot path: both layer stacks' matmuls, the
    fast output head, and the token, fast and codebook embedding tables
    (per row).  Norms, biases and ``fast_project_in`` stay as they are."""
    out = dict(params)
    out["layers"] = _quantize_layer_stack(params["layers"])
    out["fast_layers"] = _quantize_layer_stack(params["fast_layers"])
    out["fast_output"] = quantize_weight(params["fast_output"], axis=1)
    out["embeddings"] = quantize_weight(params["embeddings"], axis=1)
    out["fast_embeddings"] = quantize_weight(params["fast_embeddings"], axis=1)
    out["codebook_embeddings"] = quantize_weight(params["codebook_embeddings"], axis=1)
    if "output" in params:
        out["output"] = quantize_weight(params["output"], axis=1)
    return out


def quantized_bytes(params: Params) -> int:
    """Bytes of every leaf of a (quantized or float) tree."""
    from fish_tts_tpu_torch.utils.checkpoint import flatten_params

    return sum(t.numel() * t.element_size() for t in flatten_params(params).values())
