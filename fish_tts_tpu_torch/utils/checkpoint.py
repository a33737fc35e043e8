"""Checkpoint loading for the PyTorch port.

- ``load_safetensors`` / ``load_params`` read the native ``lm.safetensors``
  and ``vocoder.safetensors`` files with torch and numpy alone (the format
  is an 8-byte little-endian header length, a JSON header and raw
  little-endian tensor data); the ``safetensors`` package is not needed.
  Keys are the JAX package's flattened ``a/b/0/c`` paths and the arrays
  keep its layout.
- ``from_jax_params`` carries a parameter tree in the JAX package's layout
  (numpy arrays or tensors, e.g. from ``load_params`` or
  ``fish_tts_tpu.utils.checkpoint.flatten_params``) into the port's: for a
  DualAR LM tree every linear weight is transposed from ``(in, out)`` to
  ``(out, in)``; the attention biases (``wqkv_b`` (L, qkv), ``wo_b``
  (L, D)) and qk-norm gains (``q_norm``/``k_norm`` (L, Dh)) keep their
  layout, which is the one ``models/dual_ar.py`` reads; codec trees keep
  their layout.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

Params = dict[str, Any]

_DTYPES = {
    "F64": (np.float64, None),
    "F32": (np.float32, None),
    "F16": (np.float16, None),
    "BF16": (np.uint16, torch.bfloat16),
    "I64": (np.int64, None),
    "I32": (np.int32, None),
    "I16": (np.int16, None),
    "I8": (np.int8, None),
    "U8": (np.uint8, None),
    "BOOL": (np.bool_, None),
}


def load_safetensors(path: str | Path) -> dict[str, torch.Tensor]:
    """Read every tensor of a safetensors file into CPU tensors."""
    data = Path(path).read_bytes()
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8:8 + n])
    base = 8 + n
    out: dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = info["dtype"]
        if dtype not in _DTYPES:
            raise ValueError(f"{name}: unsupported safetensors dtype {dtype}")
        np_dtype, view = _DTYPES[dtype]
        start, end = info["data_offsets"]
        arr = np.frombuffer(data, dtype=np.dtype(np_dtype).newbyteorder("<"),
                            count=(end - start) // np.dtype(np_dtype).itemsize,
                            offset=base + start)
        t = torch.from_numpy(arr.astype(np_dtype, copy=True)).reshape(info["shape"])
        out[name] = t.view(view) if view is not None else t
    return out


def unflatten_params(flat: Mapping[str, Any]) -> Params:
    """``a/b/0/c`` keys -> nested dicts, with all-digit key levels as lists."""
    root: Params = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def load_params(path: str | Path) -> Params:
    """A native safetensors checkpoint as a tree in the JAX package's layout."""
    return unflatten_params(load_safetensors(path))


def _to_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bfloat16 from JAX
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


# LM weights stored (in, out) by the JAX package; the port keeps (out, in).
_STACK_LINEAR = ("wqkv", "wo", "w1", "w3", "w2")


def _transpose_linear(w):
    """(.., in, out) -> (.., out, in) for a plain or quantized weight."""
    if isinstance(w, dict) and "q" in w:
        # JAX scale (.., 1, out) -> (.., out, 1): broadcastable to (out, in)
        return {"q": w["q"].transpose(-1, -2).contiguous(),
                "s": w["s"].transpose(-1, -2).contiguous()}
    return w.transpose(-1, -2).contiguous()


def from_jax_params(tree: Params, device: str | torch.device = "cpu") -> Params:
    """JAX-layout parameter tree -> the port's tree on ``device``."""
    tree = _tree_map(_to_tensor, tree)
    if "fast_layers" in tree:  # a DualAR LM tree
        tree = dict(tree)
        for stack in ("layers", "fast_layers"):
            st = dict(tree[stack])
            for k in _STACK_LINEAR:
                st[k] = _transpose_linear(st[k])
            tree[stack] = st
        for k in ("fast_output", "output"):
            if k in tree:
                tree[k] = _transpose_linear(tree[k])
        if "fast_project_in" in tree:
            p = dict(tree["fast_project_in"])
            p["w"] = _transpose_linear(p["w"])
            tree["fast_project_in"] = p
    return _tree_map(lambda t: t.to(device), tree)


def to_device(tree: Params, device: str | torch.device, dtype=None) -> Params:
    """Move a tree to ``device``; with ``dtype``, cast floating leaves,
    leaving quantized ``{"q", "s"}`` weights alone (their f32 scales must
    not be rounded)."""
    def walk(p):
        if isinstance(p, dict) and "q" in p and "s" in p:
            return {"q": p["q"].to(device), "s": p["s"].to(device)}
        if isinstance(p, dict):
            return {k: walk(v) for k, v in p.items()}
        if isinstance(p, (list, tuple)):
            return [walk(v) for v in p]
        if dtype is not None and p.is_floating_point():
            return p.to(device=device, dtype=dtype)
        return p.to(device)

    return walk(tree)
