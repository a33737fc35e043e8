"""Checkpoint conversion, native storage and loading for the PyTorch port.

- ``convert_lm_state_dict`` / ``convert_vocoder_state_dict``: the
  reference's ``model.pth`` / ``codec.pth`` state dicts -> parameter trees
  in the JAX package's layout as numpy arrays, the port's copy of
  ``fish_tts_tpu/utils/checkpoint.py``'s converters: the ``state_dict``
  unwrap, anchored ``model.`` / ``generator.`` prefix strips, legacy
  ``wq/wk/wv`` fusion, linear weights transposed to ``(in, out)``, torch
  weight norm (``weight_g/weight_v`` and
  ``parametrizations.weight.original0/1``) folded in numpy float64, and a
  key-coverage audit (``CoverageReport``) against the expected drops.
- ``save_params`` writes such a tree as safetensors with ``/``-joined
  paths (bf16 through ``torch.bfloat16``, round to nearest even, for
  float32 leaves of two or more dimensions) without the ``safetensors``
  package; ``convert_checkpoint_dir`` turns a reference directory into a
  native one (``lm.safetensors``, ``vocoder.safetensors``,
  ``vocoder_config.json``).  A directory converted by either package
  loads in both.
- ``load_safetensors`` / ``load_params`` read the native files with torch
  and numpy alone (the format is an 8-byte little-endian header length, a
  JSON header and raw little-endian tensor data).  Keys are the JAX
  package's flattened ``a/b/0/c`` paths and the arrays keep its layout.
- ``from_jax_params`` carries a parameter tree in the JAX package's layout
  (numpy arrays or tensors, from ``load_params`` or the converters) into
  the port's: for a DualAR LM tree every linear weight is transposed from
  ``(in, out)`` to ``(out, in)``; the attention biases (``wqkv_b``
  (L, qkv), ``wo_b`` (L, D)) and qk-norm gains (``q_norm``/``k_norm``
  (L, Dh)) keep their layout, which is the one ``models/dual_ar.py``
  reads; codec trees keep their layout.
"""

from __future__ import annotations

import difflib
import fnmatch
import json
import logging
import pickle
import shutil
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Mapping

import numpy as np
import torch

from fish_tts_tpu_torch.config import DualARConfig, VocoderConfig

logger = logging.getLogger(__name__)

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


# ---------------------------------------------------------------------------
# Conversion from the reference's torch checkpoints
# ---------------------------------------------------------------------------

# Checkpoint keys the conversion never consumes on purpose; anything else
# left unconsumed is reported (``CoverageReport``), so a mistyped key cannot
# pass as a silently unloaded weight.
#
# LM: the multimodal ``audio_*`` projections the reference drops, and
# derived buffers (RoPE tables, causal mask, KV caches) in case a checkpoint
# was saved with them.
LM_EXPECTED_DROPS: tuple[str, ...] = (
    "audio_*",
    "*freqs_cis",
    "*causal_mask",
    "*.k_cache",
    "*.v_cache",
)
# Codec: the per-stage decoder transformers of ``decoder_transformer_layers``,
# which the reference's decoder blocks never build (matched by content), and
# the derived RoPE and mask buffers of its transformers.
VOCODER_EXPECTED_DROPS: tuple[str, ...] = (
    "decoder.*attention*",
    "decoder.*feed_forward*",
    "decoder.*norm*",
    "decoder.*layer_scale*",
    "decoder.*input_proj*",
    "decoder.*output_proj*",
    "*.freqs_cis",
    "*.causal_mask",
)


@dataclass(frozen=True)
class CoverageReport:
    """Key-coverage audit of one state-dict conversion: ``unconsumed`` keys
    are in the checkpoint, not read by the converter and not matched by the
    expected drops, each a weight that did not reach the model."""

    total: int
    consumed: int
    expected_dropped: tuple[str, ...]
    unconsumed: tuple[str, ...]

    @property
    def ok(self) -> bool:
        return not self.unconsumed

    def summary(self) -> str:
        lines = [
            f"{self.consumed}/{self.total} checkpoint keys consumed, "
            f"{len(self.expected_dropped)} expected drops, "
            f"{len(self.unconsumed)} UNCONSUMED"
        ]
        for k in self.expected_dropped:
            lines.append(f"  dropped (expected): {k}")
        for k in self.unconsumed:
            lines.append(f"  UNCONSUMED: {k}")
        return "\n".join(lines)


def _to_np(t) -> np.ndarray:
    """A state-dict value as numpy: a bf16 tensor widens to float32."""
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(t)


def _fold_wn_np(v: np.ndarray, g: np.ndarray) -> np.ndarray:
    """Weight norm folded into a plain kernel, ``g * v / |v|`` over every
    axis but the first, in float64."""
    norm = np.sqrt((v.astype(np.float64) ** 2).sum(axis=tuple(range(1, v.ndim)), keepdims=True))
    return (g.astype(np.float64) * v / norm).astype(np.float32)


class _SD:
    """State-dict view with weight-norm-aware conv and linear accessors.
    Every read is recorded in ``used`` for :meth:`coverage`; a read of a
    missing key raises with the closest present keys named."""

    def __init__(self, sd: Mapping[str, Any]):
        self.sd = dict(sd)
        self.used: set[str] = set()

    def has(self, key: str) -> bool:
        return key in self.sd

    def get(self, key: str) -> np.ndarray:
        if key not in self.sd:
            close = difflib.get_close_matches(key, self.sd.keys(), n=3, cutoff=0.5)
            hint = f"; closest present keys: {close}" if close else ""
            raise KeyError(f"checkpoint key {key!r} not found (expected by the converter){hint}")
        self.used.add(key)
        return _to_np(self.sd[key])

    def coverage(self, expected_drops: tuple[str, ...]) -> CoverageReport:
        leftover = sorted(set(self.sd) - self.used)
        dropped = tuple(k for k in leftover
                        if any(fnmatch.fnmatch(k, p) for p in expected_drops))
        unconsumed = tuple(k for k in leftover if k not in set(dropped))
        return CoverageReport(total=len(self.sd), consumed=len(self.used),
                              expected_dropped=dropped, unconsumed=unconsumed)

    def conv(self, prefix: str) -> dict[str, np.ndarray]:
        """Conv kernel and bias at ``prefix``, weight norm folded."""
        for gk, vk in (
            (f"{prefix}.parametrizations.weight.original0",
             f"{prefix}.parametrizations.weight.original1"),
            (f"{prefix}.weight_g", f"{prefix}.weight_v"),
        ):
            if self.has(gk):
                w = _fold_wn_np(self.get(vk), self.get(gk))
                break
        else:
            w = self.get(f"{prefix}.weight")
        out = {"w": w}
        if self.has(f"{prefix}.bias"):
            out["b"] = self.get(f"{prefix}.bias")
        return out

    def linear(self, prefix: str, bias: bool | None = None) -> dict[str, np.ndarray]:
        """Linear at ``prefix``, transposed to (in, out)."""
        out = {"w": np.ascontiguousarray(self.get(f"{prefix}.weight").T)}
        if bias is None:
            bias = self.has(f"{prefix}.bias")
        if bias:
            out["b"] = self.get(f"{prefix}.bias")
        return out

    def weight_t(self, key: str) -> np.ndarray:
        return np.ascontiguousarray(self.get(key).T)


def _normalize_lm_keys(raw: Mapping[str, Any]) -> dict[str, Any]:
    """Unwrap ``state_dict`` and strip a leading ``model.`` from each key
    that has one (anchored per key, so neither a stray first entry nor a
    ``model.`` inside a path changes the result).  ``audio_*`` keys stay,
    for the audit to report them as expected drops."""
    sd = dict(raw)
    if "state_dict" in sd:
        sd = dict(sd["state_dict"])
    if any(k.startswith("model.") for k in sd):
        sd = {(k[len("model."):] if k.startswith("model.") else k): v for k, v in sd.items()}
    return sd


def _fuse_wqkv(sd: dict[str, Any]) -> dict[str, Any]:
    """Legacy checkpoints store wq/wk/wv apart: concatenate them in q, k, v
    order."""
    out = dict(sd)
    prefixes = {k[: -len("wq.weight")] for k in sd if k.endswith("wq.weight")}
    for p in prefixes:
        wq, wk, wv = (_to_np(out.pop(p + f"w{n}.weight")) for n in "qkv")
        out[p + "wqkv.weight"] = np.concatenate([wq, wk, wv], axis=0)
    return out


def _stack_layers(sd: _SD, n_layers: int, prefix: str, cfg_has_qk_norm: bool, qkv_bias: bool,
                  o_bias: bool) -> Params:
    """Per-layer torch keys -> stacked (L, ...) arrays, linears (in, out)."""

    def stacked(fn: Callable[[int], np.ndarray]) -> np.ndarray:
        return np.stack([fn(i) for i in range(n_layers)], axis=0)

    p: Params = {
        "wqkv": stacked(lambda i: sd.weight_t(f"{prefix}.{i}.attention.wqkv.weight")),
        "wo": stacked(lambda i: sd.weight_t(f"{prefix}.{i}.attention.wo.weight")),
        "w1": stacked(lambda i: sd.weight_t(f"{prefix}.{i}.feed_forward.w1.weight")),
        "w3": stacked(lambda i: sd.weight_t(f"{prefix}.{i}.feed_forward.w3.weight")),
        "w2": stacked(lambda i: sd.weight_t(f"{prefix}.{i}.feed_forward.w2.weight")),
        "attention_norm": stacked(lambda i: sd.get(f"{prefix}.{i}.attention_norm.weight")),
        "ffn_norm": stacked(lambda i: sd.get(f"{prefix}.{i}.ffn_norm.weight")),
    }
    if qkv_bias:
        p["wqkv_b"] = stacked(lambda i: sd.get(f"{prefix}.{i}.attention.wqkv.bias"))
    if o_bias:
        p["wo_b"] = stacked(lambda i: sd.get(f"{prefix}.{i}.attention.wo.bias"))
    if cfg_has_qk_norm:
        p["q_norm"] = stacked(lambda i: sd.get(f"{prefix}.{i}.attention.q_norm.weight"))
        p["k_norm"] = stacked(lambda i: sd.get(f"{prefix}.{i}.attention.k_norm.weight"))
    return p


def convert_lm_state_dict(raw: Mapping[str, Any], cfg: DualARConfig, *,
                          report_out: list[CoverageReport] | None = None) -> Params:
    """torch ``model.pth`` state dict -> DualAR tree in the JAX package's
    layout (numpy leaves).  A missing expected key raises; unconsumed keys
    are logged, and with ``report_out`` the :class:`CoverageReport` is
    appended there."""
    sd = _SD(_fuse_wqkv(_normalize_lm_keys(raw)))
    params: Params = {
        "embeddings": sd.get("embeddings.weight"),
        "codebook_embeddings": sd.get("codebook_embeddings.weight"),
        "layers": _stack_layers(sd, cfg.n_layer, "layers", cfg.attention_qk_norm,
                                cfg.attention_qkv_bias, cfg.attention_o_bias),
        "norm": sd.get("norm.weight"),
        "fast_embeddings": sd.get("fast_embeddings.weight"),
        "fast_layers": _stack_layers(sd, cfg.n_fast_layer, "fast_layers",
                                     cfg.fast_attention_qk_norm, cfg.fast_attention_qkv_bias,
                                     cfg.fast_attention_o_bias),
        "fast_norm": sd.get("fast_norm.weight"),
        "fast_output": sd.weight_t("fast_output.weight"),
    }
    if not cfg.tie_word_embeddings:
        params["output"] = sd.weight_t("output.weight")
    if cfg.fast_dim != cfg.dim and sd.has("fast_project_in.weight"):
        params["fast_project_in"] = sd.linear("fast_project_in")
    _audit(sd, LM_EXPECTED_DROPS, "LM", report_out)
    return params


def _audit(sd: _SD, expected_drops: tuple[str, ...], what: str,
           report_out: list[CoverageReport] | None) -> None:
    rep = sd.coverage(expected_drops)
    if report_out is not None:
        report_out.append(rep)
    if rep.expected_dropped:
        logger.info("%s conversion dropped %d expected key(s): %s", what,
                    len(rep.expected_dropped), ", ".join(rep.expected_dropped))
    if not rep.ok:
        logger.warning("%s conversion left %d checkpoint key(s) UNCONSUMED; these weights "
                       "did not reach the model:\n  %s", what, len(rep.unconsumed),
                       "\n  ".join(rep.unconsumed))


def _wlt_from_sd(sd: _SD, prefix: str, n_layers: int) -> Params:
    def stacked(fmt: str) -> np.ndarray:
        return np.stack([sd.get(fmt.format(i=i)) for i in range(n_layers)], axis=0)

    def stacked_t(fmt: str) -> np.ndarray:
        return np.stack([np.ascontiguousarray(sd.get(fmt.format(i=i)).T)
                         for i in range(n_layers)], axis=0)

    p: Params = {
        "layers": {
            "wqkv": stacked_t(prefix + ".layers.{i}.attention.wqkv.weight"),
            "wo": stacked_t(prefix + ".layers.{i}.attention.wo.weight"),
            "w1": stacked_t(prefix + ".layers.{i}.feed_forward.w1.weight"),
            "w3": stacked_t(prefix + ".layers.{i}.feed_forward.w3.weight"),
            "w2": stacked_t(prefix + ".layers.{i}.feed_forward.w2.weight"),
            "attention_norm": stacked(prefix + ".layers.{i}.attention_norm.weight"),
            "ffn_norm": stacked(prefix + ".layers.{i}.ffn_norm.weight"),
            "attn_scale": stacked(prefix + ".layers.{i}.attention_layer_scale.gamma"),
            "ffn_scale": stacked(prefix + ".layers.{i}.ffn_layer_scale.gamma"),
        },
        "norm": sd.get(f"{prefix}.norm.weight"),
    }
    if sd.has(f"{prefix}.input_proj.weight"):
        p["input_proj"] = sd.linear(f"{prefix}.input_proj")
        p["output_proj"] = sd.linear(f"{prefix}.output_proj")
    if sd.has(prefix + ".layers.0.attention.rel_pos_embeddings"):
        # the conformer variant's table loads though no forward reads it
        p["layers"]["rel_pos_embeddings"] = stacked(
            prefix + ".layers.{i}.attention.rel_pos_embeddings")
    return p


def _residual_unit_from_sd(sd: _SD, prefix: str) -> Params:
    return {
        "snake1": sd.get(f"{prefix}.block.0.alpha"),
        "conv1": (sd.conv(f"{prefix}.block.1.conv") if sd.has(f"{prefix}.block.1.conv.bias")
                  else sd.conv(f"{prefix}.block.1")),
        "snake2": sd.get(f"{prefix}.block.2.alpha"),
        "conv2": (sd.conv(f"{prefix}.block.3.conv") if sd.has(f"{prefix}.block.3.conv.bias")
                  else sd.conv(f"{prefix}.block.3")),
    }


def _convnext_from_sd(sd: _SD, prefix: str) -> Params:
    return {
        "dwconv": sd.conv(f"{prefix}.dwconv.conv"),
        "norm_w": sd.get(f"{prefix}.norm.weight"),
        "norm_b": sd.get(f"{prefix}.norm.bias"),
        "pw1": sd.linear(f"{prefix}.pwconv1"),
        "pw2": sd.linear(f"{prefix}.pwconv2"),
        "gamma": sd.get(f"{prefix}.gamma"),
    }


def _vq_from_sd(sd: _SD, prefix: str) -> Params:
    return {
        "in_proj": sd.conv(f"{prefix}.in_proj"),
        "out_proj": sd.conv(f"{prefix}.out_proj"),
        "codebook": sd.get(f"{prefix}.codebook.weight"),
    }


def convert_vocoder_state_dict(raw: Mapping[str, Any], cfg: VocoderConfig, *,
                               report_out: list[CoverageReport] | None = None) -> Params:
    """torch ``codec.pth`` state dict -> codec tree (numpy leaves), audited
    like :func:`convert_lm_state_dict`.  Keys under ``generator.`` are taken
    with the prefix stripped (anchored: a key merely containing
    ``generator`` is not a prefix)."""
    sd_raw = dict(raw)
    if "state_dict" in sd_raw:
        sd_raw = dict(sd_raw["state_dict"])
    if any(k.startswith("generator.") for k in sd_raw):
        sd_raw = {k[len("generator."):]: v for k, v in sd_raw.items()
                  if k.startswith("generator.")}
    sd = _SD(sd_raw)

    # encoder Sequential: 0 stem conv, 1..N blocks, N+1 Snake, N+2 final conv
    n_stages = len(cfg.encoder_rates)
    enc: Params = {"stem": sd.conv("encoder.block.0.conv"), "blocks": []}
    for b in range(n_stages):
        base = f"encoder.block.{b + 1}.block"
        block: Params = {
            "units": [_residual_unit_from_sd(sd, f"{base}.{u}") for u in range(3)],
            "snake": sd.get(f"{base}.3.alpha"),
            "down": sd.conv(f"{base}.4.conv"),
        }
        n_t = cfg.encoder_transformer_layers[b]
        if n_t > 0:
            block["wlt"] = _wlt_from_sd(sd, f"{base}.5", n_t)
        enc["blocks"].append(block)
    enc["final_snake"] = sd.get(f"encoder.block.{n_stages + 1}.alpha")
    enc["final_conv"] = sd.conv(f"encoder.block.{n_stages + 2}.conv")

    tq_layers = cfg.quantizer_transformer.n_layer
    quant: Params = {
        "downsample": [
            {"conv": sd.conv(f"quantizer.downsample.{i}.0.conv"),
             "convnext": _convnext_from_sd(sd, f"quantizer.downsample.{i}.1")}
            for i in range(len(cfg.downsample_factor))
        ],
        "pre": _wlt_from_sd(sd, "quantizer.pre_module", tq_layers),
        "post": _wlt_from_sd(sd, "quantizer.post_module", tq_layers),
        "semantic": _vq_from_sd(sd, "quantizer.semantic_quantizer.quantizers.0"),
        "residual": [_vq_from_sd(sd, f"quantizer.quantizer.quantizers.{i}")
                     for i in range(cfg.n_residual_codebooks)],
        "upsample": [
            {"tconv": sd.conv(f"quantizer.upsample.{i}.0.conv"),
             "convnext": _convnext_from_sd(sd, f"quantizer.upsample.{i}.1")}
            for i in range(len(cfg.downsample_factor))
        ],
    }

    # decoder Sequential: 0 stem, 1..N blocks, N+1 Snake, N+2 conv, N+3 Tanh
    n_dec = len(cfg.decoder_rates)
    dec: Params = {"stem": sd.conv("decoder.model.0.conv"), "blocks": []}
    for b in range(n_dec):
        base = f"decoder.model.{b + 1}.block"
        dec["blocks"].append({
            "snake": sd.get(f"{base}.0.alpha"),
            "up": sd.conv(f"{base}.1.conv"),
            "units": [_residual_unit_from_sd(sd, f"{base}.{u}") for u in range(2, 5)],
        })
    dec["final_snake"] = sd.get(f"decoder.model.{n_dec + 1}.alpha")
    dec["final_conv"] = sd.conv(f"decoder.model.{n_dec + 2}.conv")

    _audit(sd, VOCODER_EXPECTED_DROPS, "Vocoder", report_out)
    return {"encoder": enc, "quantizer": quant, "decoder": dec}


# ---------------------------------------------------------------------------
# Native storage: writing
# ---------------------------------------------------------------------------

_DTYPE_NAMES = {np.dtype(np_dtype): name for name, (np_dtype, view) in _DTYPES.items()
                if view is None}


def flatten_params(params: Params, prefix: str = "") -> dict[str, Any]:
    """A tree as ``{"a/b/0/c": leaf}``, lists keyed by their indices."""
    flat: dict[str, Any] = {}
    if isinstance(params, dict):
        for k, v in params.items():
            flat.update(flatten_params(v, f"{prefix}{k}/"))
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            flat.update(flatten_params(v, f"{prefix}{i}/"))
    else:
        flat[prefix[:-1]] = params
    return flat


def _stored(leaf, dtype: str) -> tuple[str, np.ndarray]:
    """(safetensors dtype name, little-endian array of the stored bytes)."""
    arr = np.asarray(leaf)
    if dtype == "bf16" and arr.dtype == np.float32 and arr.ndim > 1:
        bits = torch.from_numpy(np.ascontiguousarray(arr)).to(torch.bfloat16).view(torch.int16)
        return "BF16", bits.numpy()
    if arr.dtype not in _DTYPE_NAMES:
        raise ValueError(f"unsupported dtype {arr.dtype} for safetensors")
    return _DTYPE_NAMES[arr.dtype], np.ascontiguousarray(arr, dtype=arr.dtype.newbyteorder("<"))


def save_params(path: str | Path, params: Params, dtype: str = "bf16") -> None:
    """Save a tree as safetensors, readable by :func:`load_safetensors` and
    by the JAX package's ``load_params``.  ``dtype="bf16"`` stores float32
    leaves of two or more dimensions as bfloat16 (round to nearest even);
    1-D leaves (norm gains, biases) keep float32.  ``"fp32"`` stores every
    leaf as it is."""
    if dtype not in ("bf16", "fp32"):
        raise ValueError(f"dtype={dtype!r}: expected 'bf16' or 'fp32'")
    arrays: dict[str, np.ndarray] = {}
    header: dict[str, Any] = {}
    offset = 0
    for key, leaf in flatten_params(params).items():
        name, arr = _stored(leaf, dtype)
        arrays[key] = arr
        header[key] = {"dtype": name, "shape": list(arr.shape),
                       "data_offsets": [offset, offset + arr.nbytes]}
        offset += arr.nbytes
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for arr in arrays.values():
            f.write(arr.reshape(-1).view(np.uint8).data)


# ---------------------------------------------------------------------------
# Reference checkpoint directories
# ---------------------------------------------------------------------------


def load_torch_pickle(path: str | Path) -> Mapping[str, Any]:
    """A ``model.pth`` state dict, memory-mapped, tensors only."""
    return torch.load(str(path), map_location="cpu", mmap=True, weights_only=True)


def load_codec_pickle(path: str | Path) -> Mapping[str, Any]:
    """A ``codec.pth`` state dict.  Some pickle non-tensor state: only when
    the tensors-only load refuses one does this unpickle it whole, with a
    warning."""
    try:
        return torch.load(str(path), map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        logger.warning("%s is not loadable with weights_only=True; falling back to full "
                       "unpickling: only do this for checkpoints you trust", path)
        return torch.load(str(path), map_location="cpu", weights_only=False)


def load_lm_dir(d: str | Path, cfg: DualARConfig) -> Params:
    """The LM of a checkpoint directory as a tree in the JAX package's
    layout: ``lm.safetensors``, or else ``model.pth`` converted."""
    d = Path(d)
    if (d / "lm.safetensors").exists():
        return load_params(d / "lm.safetensors")
    if (d / "model.pth").exists():
        return convert_lm_state_dict(load_torch_pickle(d / "model.pth"), cfg)
    raise FileNotFoundError(f"No LM weights in {d}")


def load_vocoder_file(f: str | Path, cfg: VocoderConfig) -> Params:
    """A codec as a tree: a ``.safetensors`` file as it is, any other file
    as a ``codec.pth`` converted."""
    f = Path(f)
    if f.suffix == ".safetensors":
        return load_params(f)
    return convert_vocoder_state_dict(load_codec_pickle(f), cfg)


def convert_checkpoint_dir(model_dir: str | Path, out_dir: str | Path,
                           cfg: DualARConfig | None = None, lm_dtype: str = "bf16",
                           vocoder_dtype: str = "fp32",
                           vocoder_cfg: VocoderConfig | None = None) -> dict[str, CoverageReport]:
    """Convert a reference checkpoint directory (``config.json``,
    ``model.pth``, ``codec.pth``, ``tokenizer.tiktoken``) into the native
    format: ``lm.safetensors`` (bf16 by default: ``model.pth`` ships bf16,
    so nothing is lost), ``vocoder.safetensors`` (fp32 by default) and
    ``vocoder_config.json``, with the config, tokenizer and
    ``special_tokens.json`` copied.  Returns the coverage reports
    (``{"lm": ..., "vocoder": ...}``)."""
    model_dir, out_dir = Path(model_dir), Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    cfg = cfg or DualARConfig.from_json(model_dir)
    vocoder_cfg = vocoder_cfg or VocoderConfig()

    reports: dict[str, CoverageReport] = {}
    out: list[CoverageReport] = []
    lm = convert_lm_state_dict(load_torch_pickle(model_dir / "model.pth"), cfg, report_out=out)
    reports["lm"] = out[0]
    save_params(out_dir / "lm.safetensors", lm, dtype=lm_dtype)
    del lm

    codec_path = model_dir / "codec.pth"
    if codec_path.exists():
        out = []
        voc = convert_vocoder_state_dict(load_codec_pickle(codec_path), vocoder_cfg,
                                         report_out=out)
        reports["vocoder"] = out[0]
        save_params(out_dir / "vocoder.safetensors", voc, dtype=vocoder_dtype)
        vocoder_cfg.to_json(out_dir / "vocoder_config.json")

    for name in ("config.json", "tokenizer.tiktoken", "special_tokens.json"):
        if (model_dir / name).exists():
            shutil.copy(model_dir / name, out_dir / name)
    return reports
