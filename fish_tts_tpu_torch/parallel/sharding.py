"""Sharding rules: port of ``fish_tts_tpu/parallel/sharding.py``.

The JAX package annotates every weight and cache with a ``NamedSharding``
and lets GSPMD insert the collectives.  Here every shard is explicit: each
(dp row, tp rank) of the mesh gets its own parameter dict
(:class:`MeshParams`), each KV cache is a :class:`ShardedKV`, and the mesh
route of ``models/dual_ar.py`` calls the collectives of
``parallel/collectives.py``.  The layout is the JAX package's
(Megatron-style tensor parallelism):

- attention: ``wqkv`` column-parallel, cut by heads: rank r holds query
  heads ``[r Hq/tp, (r+1) Hq/tp)`` and KV heads ``[r Hkv/tp, (r+1) Hkv/tp)``,
  so each GQA group stays with its KV head (query head h reads KV head
  ``h // (Hq/Hkv)``); ``wqkv_b`` is cut the same way; ``wo`` row-parallel:
  one reduction per attention block;
- FFN: ``w1``/``w3`` column-parallel over the hidden dim, ``w2``
  row-parallel: one reduction per FFN;
- the tied embedding / LM head (and an untied ``output``): vocab-sharded;
  ``fast_output``: sharded by codebook entry; logits gathered to full width
  before sampling;
- KV caches: over (dp rows of the batch, tp KV heads);
- norms, biases after a reduction, qk-norm gains, the codebook and fast
  embeddings and ``fast_project_in``: whole on every rank.

The port's linear weights are ``(out, in)`` with an int8 scale ``(..., out,
1)`` (``utils/quantize.py``), the JAX package's ``(in, out)``: so JAX's
``P(None, None, "tp")`` on ``wqkv`` is ``P(None, "tp", None)`` here, and
``wo``/``w2`` shard their ``in`` axis with their scale whole.  A spec is a
tuple with one entry per axis, ``"tp"`` or None.

The decode state's small per-stream tensors (``frame``, ``pos``, ``prev``,
``step``, ``done``, the sampling columns and the noise keys) stay whole on
the mesh's first device; only the caches are sharded.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from fish_tts_tpu_torch.config import DualARConfig
from fish_tts_tpu_torch.parallel.mesh import Mesh
from fish_tts_tpu_torch.utils.quantize import is_quantized

Params = dict[str, Any]


def P(*axes) -> tuple:
    """A partition spec: per axis, the mesh axis it is split over or None."""
    return tuple(axes)


def _layer_stack_specs(qk_norm: bool, qkv_bias: bool, o_bias: bool) -> Params:
    """Specs of one stacked block-set, (L, out, in) weights; the leading
    layer axis is never sharded."""
    specs: Params = {
        "wqkv": P(None, "tp", None),  # cut by heads (see _qkv_rows)
        "wo": P(None, None, "tp"),
        "w1": P(None, "tp", None),
        "w3": P(None, "tp", None),
        "w2": P(None, None, "tp"),
        "attention_norm": P(None, None),
        "ffn_norm": P(None, None),
    }
    if qkv_bias:
        specs["wqkv_b"] = P(None, "tp")
    if o_bias:
        specs["wo_b"] = P(None, None)
    if qk_norm:
        specs["q_norm"] = P(None, None)
        specs["k_norm"] = P(None, None)
    return specs


def param_specs(cfg: DualARConfig) -> Params:
    """The spec tree matching ``dual_ar.init_params``'s."""
    specs: Params = {
        "embeddings": P("tp", None),  # vocab-sharded tied head
        "codebook_embeddings": P(None, None),
        "layers": _layer_stack_specs(cfg.attention_qk_norm, cfg.attention_qkv_bias,
                                     cfg.attention_o_bias),
        "norm": P(None),
        "fast_embeddings": P(None, None),
        "fast_layers": _layer_stack_specs(cfg.fast_attention_qk_norm,
                                          cfg.fast_attention_qkv_bias,
                                          cfg.fast_attention_o_bias),
        "fast_norm": P(None),
        "fast_output": P("tp", None),
    }
    if not cfg.tie_word_embeddings:
        specs["output"] = P("tp", None)
    if cfg.fast_dim != cfg.dim:
        specs["fast_project_in"] = {"w": P(None, None), "b": P(None)}
    return specs


def state_specs(dp_batch: bool = True) -> Params:
    """Specs of the decode state (``engine/decode.py``): the KV caches (L, B,
    Hkv, S, Dh) over (dp rows of the batch, tp KV heads); every other field
    whole on the mesh's first device.  ``dp_batch=False`` keeps the batch
    whole in one dp row: the mesh's dp extent does not divide the batch
    (one ``generate_long`` stream on a dp > 1 mesh)."""
    kv = P(None, "dp" if dp_batch else None, "tp", None, None)
    return {"kv": {"k": kv, "v": kv}, "frame": P(None, None), "pos": P(None),
            "prev": P(None, None, None), "step": P(None), "done": P(None),
            "sampling": P(None, None, None), "noise_key": P(None)}


def expand_quant_specs(specs: Params, params: Params) -> Params:
    """Adapt a plain-weight spec tree to the actual (possibly int8) params:
    an int8 ``{"q", "s"}`` leaf's values take the weight's spec, its scale
    the same with every size-1 axis unsharded (the scale keeps the
    contraction axis at size 1)."""

    def walk(spec, param):
        if is_quantized(param):
            s = param["s"]
            s_spec = P(*[None if s.shape[i] == 1 else (spec[i] if i < len(spec) else None)
                         for i in range(s.dim())])
            return {"q": spec, "s": s_spec}
        if isinstance(param, dict):
            return {k: walk(spec[k] if isinstance(spec, dict) else spec, v)
                    for k, v in param.items()}
        return spec

    return {k: walk(specs[k], v) for k, v in params.items()}


def _leaves(tree: Params, specs: Params, path: tuple = ()):
    """(path, tensor, spec) of every leaf, in the tree's order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, specs[k], path + (k,))
        else:
            yield path + (k,), v, specs[k]


def _keystr(path: tuple) -> str:
    return "".join(f"[{k!r}]" for k in path)


def _validate_divisible(params: Params, specs: Params, mesh: Mesh) -> None:
    """Every sharded axis must divide by its mesh extent: checked up front,
    naming the parameter."""
    for path, x, spec in _leaves(params, specs):
        for i, ax in enumerate(spec):
            if ax is not None and x.shape[i] % mesh.shape[ax]:
                raise ValueError(f"{ax}={mesh.shape[ax]} must divide axis {i} "
                                 f"(size {x.shape[i]}) of param {_keystr(path)}")


def _qkv_rows(cfg: DualARConfig, tp: int, r: int) -> torch.Tensor:
    """The rows of the fused ``wqkv`` (q, then k, then v heads) rank r holds:
    its query heads, then its KV heads of k and of v."""
    dh, hq, hkv = cfg.head_dim, cfg.n_head, cfg.n_local_heads
    q = torch.arange(r * hq // tp * dh, (r + 1) * hq // tp * dh)
    k = hq * dh + torch.arange(r * hkv // tp * dh, (r + 1) * hkv // tp * dh)
    return torch.cat([q, k, k + hkv * dh])


def _cut(path: tuple, x: torch.Tensor, spec: tuple, cfg: DualARConfig, tp: int, r: int
         ) -> torch.Tensor:
    """Rank r's part of a leaf: whole, cut by heads (``wqkv``, its scale and
    ``wqkv_b``) or in tp contiguous blocks along its ``"tp"`` axis."""
    if tp == 1 or "tp" not in spec:
        return x
    axis = spec.index("tp")
    if "wqkv" in path or path[-1] == "wqkv_b":
        stack = cfg if path[0] == "layers" else cfg.fast_config
        return x.index_select(axis, _qkv_rows(stack, tp, r).to(x.device))
    n = x.shape[axis] // tp
    return x.narrow(axis, r * n, n).contiguous()


class MeshParams(dict):
    """LM parameters on a mesh: ``ranks[i][r]`` is the parameter dict of tp
    rank r of dp row i on ``mesh.grid[i][r]`` (its shards and its copies of
    the whole leaves); ``specs`` the expanded spec tree.  As a dict it holds
    only the top-level entries every rank has whole (``norm``, the codebook
    and fast embeddings, ``fast_norm``, ``fast_project_in``), rank (0, 0)'s
    copies on the mesh's first device; reading a sharded entry raises."""

    def __init__(self, whole: Params, mesh: Mesh, ranks: list[list[Params]], specs: Params):
        super().__init__(whole)
        self.mesh = mesh
        self.ranks = ranks
        self.specs = specs

    def __missing__(self, key):
        raise KeyError(f"{key!r} is sharded over {self.mesh}: read it per rank "
                       f"(MeshParams.ranks)")


def _tree_map(fn, tree: Params, path: tuple = ()) -> Params:
    return {k: (_tree_map(fn, v, path + (k,)) if isinstance(v, dict) and not is_quantized(v)
                else fn(path + (k,), v))
            for k, v in tree.items()}


def shard_params(params: Params, cfg: DualARConfig, mesh: Mesh) -> MeshParams:
    """Place LM params (float or weight-only int8) on the mesh with the TP
    layout: one parameter dict per (dp row, tp rank)."""
    tp = mesh.shape["tp"]
    # head-granularity checks first: a fused-QKV axis divisible by tp could
    # still split mid-head; both transformer stacks are TP-sharded
    for name, heads, inter in (("", cfg.n_local_heads, cfg.intermediate_size),
                               ("fast_", cfg.fast_n_local_heads, cfg.fast_intermediate_size)):
        if heads % tp != 0:
            raise ValueError(f"tp={tp} must divide {name}n_local_heads={heads}")
        if inter % tp != 0:
            raise ValueError(f"tp={tp} must divide {name}intermediate_size={inter}")
    prepared = [k for k in params if k.startswith("_")]
    if prepared:
        raise ValueError(f"params carry fused-kernel layouts {prepared}; the kernels are "
                         "single-device — shard the plain parameters")
    specs = expand_quant_specs(param_specs(cfg), params)
    # catches the remaining sharded axes (vocab-sharded embeddings and heads)
    _validate_divisible(params, specs, mesh)

    def spec_of(path):
        s = specs
        for k in path:
            s = s[k]
        return s

    def cut(r):
        def leaf(path, x):
            if is_quantized(x):
                return {k: _cut(path + (k,), x[k], spec_of(path + (k,)), cfg, tp, r)
                        for k in ("q", "s")}
            return _cut(path, x, spec_of(path), cfg, tp, r)
        return _tree_map(leaf, params)

    local = [cut(r) for r in range(tp)]
    ranks = [[_tree_map(lambda _, x, d=d: _to(x, d), local[r]) for r, d in enumerate(row)]
             for row in mesh.grid]
    whole = {k: ranks[0][0][k] for k in params
             if not any("tp" in s for _, _, s in _leaves({k: params[k]}, {k: specs[k]}))}
    return MeshParams(whole, mesh, ranks, specs)


def _to(x, device):
    if is_quantized(x):
        return {"q": x["q"].to(device), "s": x["s"].to(device)}
    return x.to(device)


def mesh_of(params) -> Mesh | None:
    """The mesh of a :class:`MeshParams`, None for one device's params."""
    return params.mesh if isinstance(params, MeshParams) else None


def local_config(cfg: DualARConfig, tp: int) -> DualARConfig:
    """The config one tp rank computes: its share of the heads and of the
    FFN's hidden dim."""
    if tp == 1:
        return cfg
    return dataclasses.replace(cfg, n_head=cfg.n_head // tp,
                               n_local_heads=cfg.n_local_heads // tp,
                               intermediate_size=cfg.intermediate_size // tp)


def batch_rows(batch: int, mesh: Mesh) -> list[tuple[int, int, int]]:
    """(dp row, first, end) of the batch rows each dp row computes.  When dp
    does not divide the batch, row 0 computes all of it and the others stay
    idle: the JAX package replicates the batch axis then
    (``fish_tts_tpu/parallel/sharding.py:188-194``), which gives the same
    result computed dp times."""
    dp = mesh.shape["dp"]
    if batch % dp:
        return [(0, 0, batch)]
    n = batch // dp
    return [(i, i * n, (i + 1) * n) for i in range(dp)]


class ShardedKV:
    """One KV cache tensor (L, B, Hkv, S, Dh) on a mesh, held as blocks of
    batch rows: ``blocks`` lists (dp row i, first row a, parts), ``parts[r]``
    those rows' KV heads of tp rank r, (L, b, Hkv/tp, S, Dh) on
    ``mesh.grid[i][r]``.  ``narrow`` (batch or sequence axis), ``copy_``
    and ``zero_`` act on the whole as a tensor's do, so the engine's row
    views, prefix forks and slot installs take it as they take a tensor."""

    def __init__(self, mesh: Mesh, blocks: list, shape):
        self.mesh = mesh
        self.blocks = blocks
        self.shape = torch.Size(shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0][2][0].dtype

    @property
    def device(self) -> torch.device:
        return self.mesh.first

    def narrow(self, dim: int, start: int, length: int) -> "ShardedKV":
        shape = list(self.shape)
        shape[dim] = length
        if dim == 3:
            return ShardedKV(self.mesh, [(i, a, [p.narrow(3, start, length) for p in parts])
                                         for i, a, parts in self.blocks], shape)
        if dim != 1:
            raise ValueError("a ShardedKV narrows along its batch (1) or sequence (3) axis")
        blocks = []
        for i, a, parts in self.blocks:
            lo, hi = max(a, start), min(a + parts[0].shape[1], start + length)
            if lo < hi:
                blocks.append((i, lo - start, [p.narrow(1, lo - a, hi - lo) for p in parts]))
        return ShardedKV(self.mesh, blocks, shape)

    def rows(self, r: int, a: int, b: int, device) -> torch.Tensor:
        """Tp rank r's KV heads of the batch rows [a, b), on ``device``."""
        pieces = []
        for _, a0, parts in self.blocks:
            lo, hi = max(a, a0), min(b, a0 + parts[r].shape[1])
            if lo < hi:
                pieces.append(parts[r].narrow(1, lo - a0, hi - lo).to(device))
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=1)

    def copy_(self, src: "ShardedKV") -> "ShardedKV":
        """Copy ``src`` in place: a ShardedKV of the same shape, or of one
        batch row, broadcast over the rows."""
        if (src.shape[1] not in (1, self.shape[1])
                or src.shape[:1] + src.shape[2:] != self.shape[:1] + self.shape[2:]):
            raise ValueError(f"cannot copy a {tuple(src.shape)} cache into {tuple(self.shape)}")
        for _, a, parts in self.blocks:
            for r, p in enumerate(parts):
                lo, hi = (0, 1) if src.shape[1] == 1 else (a, a + p.shape[1])
                p.copy_(src.rows(r, lo, hi, p.device))
        return self

    def zero_(self) -> "ShardedKV":
        for _, _, parts in self.blocks:
            for p in parts:
                p.zero_()
        return self

    def full(self) -> torch.Tensor:
        """The whole tensor, gathered on the mesh's first device."""
        first = self.mesh.first
        return torch.cat([torch.cat([p.to(first) for p in parts], dim=2)
                          for _, _, parts in self.blocks], dim=1)


def kv_zeros(mesh: Mesh, shape, dtype: torch.dtype, dp_batch: bool = True) -> ShardedKV:
    """A zero cache of ``shape`` (L, B, Hkv, S, Dh) over (dp rows of the
    batch, tp KV heads) (:func:`batch_rows`; ``dp_batch=False``: the whole
    batch in row 0)."""
    L, B, H, S, D = shape
    tp = mesh.shape["tp"]
    rows = batch_rows(B, mesh) if dp_batch else [(0, 0, B)]
    return ShardedKV(mesh, [(i, a, [torch.zeros((L, b - a, H // tp, S, D), dtype=dtype,
                                                device=mesh.grid[i][r]) for r in range(tp)])
                            for i, a, b in rows], shape)


def shard_kv(t: torch.Tensor, mesh: Mesh, dp_batch: bool = True) -> ShardedKV:
    """A copy of one device's cache (L, B, Hkv, S, Dh) on the mesh."""
    out = kv_zeros(mesh, t.shape, t.dtype, dp_batch)
    H = t.shape[2] // mesh.shape["tp"]
    for _, a, parts in out.blocks:
        for r, p in enumerate(parts):
            p.copy_(t[:, a:a + p.shape[1], r * H:(r + 1) * H])
    return out


def shard_state(state: Params, mesh: Mesh, dp_batch: bool | None = None) -> Params:
    """A copy of one device's decode state on the mesh: the caches sharded
    (:func:`state_specs`), the rest on the mesh's first device.
    ``dp_batch=None`` shards the batch over dp iff dp divides it."""
    B = state["pos"].shape[0]
    if dp_batch is None:
        dp_batch = B % mesh.shape["dp"] == 0
    elif dp_batch and B % mesh.shape["dp"]:
        raise ValueError(f"dp={mesh.shape['dp']} must divide the batch ({B})")
    out = {k: v.to(mesh.first, copy=True) for k, v in state.items() if k != "kv"}
    out["kv"] = {k: shard_kv(v, mesh, dp_batch) for k, v in state["kv"].items()}
    return out


def shard_rope(rope: Params, mesh: Mesh) -> Params:
    """The RoPE tables on the mesh's first device: they are indexed by the
    state's positions there, and the rows each rank needs are sent to it."""
    return {k: v.to(mesh.first) for k, v in rope.items()}


def replicate(tree: Params, mesh: Mesh) -> list[list[Params]]:
    """A copy of ``tree`` for every (dp row, tp rank) of the mesh."""
    return [[_tree_map(lambda _, x, d=d: _to(x, d), tree) for d in row] for row in mesh.grid]
