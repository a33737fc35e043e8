"""The DualAR decode engine: prefill plus chunked decode.

Port of ``fish_tts_tpu/engine/decode.py``:

- ``prefill``: the whole (bucket-padded) prompt through the plain PyTorch
  transformer stack, writing the KV cache, then the first frame sampled,
  launched op by op (:func:`prefill_body` after the sampling columns and
  noise keys are loaded);
- ``decode_frame``: one frame on the state's device tensors alone: embed
  the last frame, run the slow stack against the cache, sample the next
  frame, and update the state in place.  It reads nothing back to the host,
  so a CUDA graph can hold it;
- ``decode_chunk``: ``decode_frame`` in an eager loop, on either device
  (the CPU's route, and the reference the graph is held against);
- ``DecodeGraph``: one ``decode_frame`` captured in a CUDA graph on a
  persistent state and replayed once per frame (the route on the card):
  the host pays one graph launch per frame and reads nothing back;
- ``PrefillGraph``: :func:`prefill_body` at B = 1 captured in a CUDA graph
  on a persistent state at one prompt bucket and cache read bound, replayed
  for each later prefill there from static input buffers that every replay
  rewrites whole;
- ``Runner``: one owner's (the engine's, a serving pool's) persistent
  states and the graphs captured on them.  It replays a graph where
  ``eager_because`` gives no reason (a state on the card, no mesh; for a
  prefill also B = 1 and the default noise) and runs ``prefill`` or
  ``decode_chunk`` everywhere else.

Routes.  Each frame has three parts, each on its kernel or on plain
PyTorch, decided per call by the reference's gates (:func:`route`, from the
config, the parameters, B, the penalty window and the sampler options
alone, so the CPU takes the route the card takes):

- the slow stack: ``ops/slow_stack`` (int8, no attention biases; q/k-norm
  in its own instantiation; with an untied head the kernel runs without
  its head and ``dual_ar.lm_logits`` follows), else ``dual_ar.slow_forward``
  against the cache plus ``lm_logits``;
- the slow token: ``ops/sampler_kernel`` (``top_k == -1``), else
  ``sampling.sample``;
- the residual books: ``ops/fast_decoder`` (int8, ``top_k <= 0``, no fast
  attention biases or qk-norm), else the loop over ``dual_ar.fast_step``
  with ``sampling.sample`` at ``res_k = min(256, Vr)`` candidates when
  ``top_k > 0``.

``fast_kernel=False`` puts every part on plain PyTorch, and so do
parameters on a (dp, tp) mesh (``parallel.sharding.MeshParams``): the
kernels are single-device, as the JAX package's are, and the mesh route of
``models/dual_ar.py`` is the plain one.  A kernel that fails raises; only a
gate that refuses leads to a plain route.

All-done skip, as the reference's per-frame ``lax.cond``: with ``B > 1`` or
``early_exit`` each frame computes ``skip = done.all()`` on the device; the
kernels return at once when it is set, and every state update (the plain
slow route's cache writes included) is ``where(skip, old, new)``.  A
skipped frame leaves the state as it was, emits ``state["frame"]`` and
marks nothing emitted.  Prefill's first chunk keeps the straight-line
route.

Replicated reference quirks, as in the JAX package: the slow-token penalty
reads one window *column* (:func:`penalty_column`); the fast position 0
output is discarded; the prefill frame is not recorded in the penalty
window; ``a = token - semantic_begin`` is clamped into the codebook.

RNG.  The default source (:class:`GumbelNoise`) is counter-based: lane i
of slot b at step s draws from a 32-bit integer hash of (seed, slot, step,
lane) computed with torch integer ops on the device, so frames depend on
neither the batch nor how decode is cut into chunks, and the CPU and the
card draw the same bits.  Each route reads the first lanes it needs (see
:class:`Draws`).  A test may instead pass a host source called per (slot,
step, Draws) that returns ``(g_slow (slow,), g_fast (K-1, fast))``, the
draws of the JAX package's route; it runs only eagerly, since it reads the
steps back.  The prefill frame uses step :data:`PREFILL_STEP`, which no
decode step reaches.

State is a dict of device tensors, all updated in place (a captured graph
holds their addresses): ``kv`` {"k", "v"} (L, B, Hkv, S, Dh) (on a mesh,
``ShardedKV``s; every other field on the mesh's first device), ``frame``
(B, 1+K), ``pos`` (B,) int32, ``prev`` (B, 1+K, W) penalty window, ``step``
(B,) int32, ``done`` (B,) bool, ``sampling`` (3, B, 1) f32 (temperature,
top-p and penalty columns) and ``noise_key`` (B,) int64 (the default
source's key of each slot).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable

import torch

from fish_tts_tpu_torch.config import DualARConfig
from fish_tts_tpu_torch.engine.sampling import candidate_width, sample
from fish_tts_tpu_torch.models import dual_ar
from fish_tts_tpu_torch.models.dual_ar import Params, TokenIds
from fish_tts_tpu_torch.ops import fast_decoder, sampler_kernel, slow_stack
from fish_tts_tpu_torch.ops.attention import NEG_INF
from fish_tts_tpu_torch.parallel.sharding import MeshParams, mesh_of
from fish_tts_tpu_torch.utils.quantize import qgather

WINDOW = 16  # default repetition-penalty window
PREFILL_STEP = 0x7FFFFFFF  # noise step of the prefill frame

# Frames run by the eager loop and frames replayed from a captured graph,
# and the same for prefills (calls of ``prefill``, replays of a
# ``PrefillGraph``), for showing which route a run took.
eager_frames = 0
graph_replays = 0
prefill_eager = 0
prefill_replays = 0

RES_K = 256  # residual-book candidates when top_k > 0 (the JAX package's res_k)

State = dict[str, Any]


@dataclass(frozen=True)
class Draws:
    """The noise lanes a frame reads: ``slow`` for the slow token, ``fast``
    per residual book; ``per_book`` when the JAX package draws each book
    from its own key (its plain loop) rather than one (K-1, Vr) block (its
    fast-decoder kernel)."""

    slow: int
    fast: int
    per_book: bool


@dataclass(frozen=True)
class Route:
    """Which parts of a frame run their kernel, and the sampler options."""

    slow_stack: bool
    sampler: bool
    fast: bool
    top_k: int = -1
    approx: bool = False

    @property
    def res_k(self) -> int:
        """The residual books' sampler mode on the plain loop."""
        return RES_K if self.top_k > 0 else self.top_k

    def draws(self, cfg: DualARConfig) -> Draws:
        V, Vr = cfg.vocab_size, cfg.residual_codebook_size
        slow = V if self.sampler else candidate_width(V, self.top_k)
        if self.fast:
            return Draws(slow, Vr, per_book=False)
        return Draws(slow, candidate_width(Vr, min(self.res_k, Vr)), per_book=True)


def route(cfg: DualARConfig, params: Params, batch: int, window: int, *, top_k: int = -1,
          approx: bool = False, fast_kernel: bool = True) -> Route:
    """The reference's per-call gates: each part of the frame on its kernel
    when ``fast_kernel`` is set and the kernel's ``supports`` takes it (never
    for parameters on a mesh)."""
    fast_kernel = fast_kernel and not isinstance(params, MeshParams)
    return Route(
        slow_stack=fast_kernel and slow_stack.supports(cfg, params, batch),
        sampler=fast_kernel and sampler_kernel.supports(batch, top_k),
        fast=(fast_kernel and top_k <= 0
              and fast_decoder.supports(cfg, params, batch, window)),
        top_k=top_k, approx=approx)


HostNoise = Callable[[int, int, Draws], tuple[torch.Tensor, torch.Tensor]]

_M32 = 0xFFFFFFFF
# Odd multipliers below 2**31: a 32-bit word times one stays inside int64.
_MUL = (0x7FEB352D, 0x6C8E9CF5)


def _mix32(x):
    """A bijective 32-bit integer mixer (two xorshift-multiply rounds) on a
    Python int or an int64 tensor holding 32-bit words."""
    x = x ^ (x >> 16)
    x = (x * _MUL[0]) & _M32
    x = x ^ (x >> 15)
    x = (x * _MUL[1]) & _M32
    return x ^ (x >> 16)


def gumbel_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel samples ``-log(-log(u))`` with u kept above 0."""
    tiny = torch.finfo(u.dtype).tiny
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


@functools.cache
def _lane_hashes(n: int, device: torch.device) -> torch.Tensor:
    """``mix32(i)`` for lanes i < n, int64 on ``device``; made once."""
    return _mix32(torch.arange(n, dtype=torch.int64, device=device))


def gumbel_draws(keys: torch.Tensor, step: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n) float64 Gumbel draws: lane i of slot b from the 32-bit word
    ``mix32(mix32(i) ^ mix32(keys[b] ^ step[b]))``, u = (word + 1/2) / 2**32,
    ``-log(-log(u))`` in float64 (rounded to f32 by the caller, the same
    bits on the CPU and the card in practice)."""
    k = _mix32(keys ^ step.long())
    x = _mix32(_lane_hashes(n, keys.device)[None] ^ k[:, None])
    return x.double().add_(0.5).mul_(2.0 ** -32).log_().neg_().log_().neg_()


def default_draws(cfg: DualARConfig, keys: torch.Tensor, step: torch.Tensor):
    """The default source's draws of the slots keyed ``keys`` (B,) int64 at
    ``step`` (B,), on their device: ((B, V), (B, K-1, Vr)) f32.  A plain
    route reads the first lanes of each row it needs."""
    V, K1, Vr = cfg.vocab_size, cfg.num_codebooks - 1, cfg.residual_codebook_size
    g = gumbel_draws(keys, step, V + K1 * Vr)
    return g[:, :V].float().contiguous(), g[:, V:].float().reshape(-1, K1, Vr)


class GumbelNoise:
    """Default noise source: counter-based Gumbel draws keyed by (seed, slot,
    step), computed on the device (see the module docstring).  ``prefill``
    and ``decode_chunk`` load :meth:`slot_keys` into ``state["noise_key"]``;
    :func:`default_draws` then needs nothing from the host.  ``cfg`` and
    ``device`` are accepted for compatibility: the draws take their shapes
    from the frame's config and land on the state's device."""

    def __init__(self, seed: int, cfg: DualARConfig, device=None):
        self.seed = int(seed)

    def slot_keys(self, slots) -> list[int]:
        """The 32-bit key of each slot: a hash of (seed, slot)."""
        lo, hi = self.seed & _M32, (self.seed >> 32) & _M32
        return [_mix32(_mix32(_mix32(s) ^ lo) ^ hi) for s in slots]


class KeyedNoise(GumbelNoise):
    """The default source with each slot's key given: row b draws with
    ``keys[b]``.  The continuous batcher prefills a group of requests with
    it, each row keyed as its request's slot 0 would be in a solo run."""

    def __init__(self, keys):
        super().__init__(0, None)
        self.keys = [int(k) for k in keys]

    def slot_keys(self, slots) -> list[int]:
        return [self.keys[s] for s in slots]


def _host_draws(noise: HostNoise, step: torch.Tensor, draws: Draws, device):
    """A host source's draws of every slot at its own step (reads the steps
    back, so it runs only eagerly): ((B, slow), (B, K-1, fast))."""
    got = [noise(b, s, draws) for b, s in enumerate(step.tolist())]
    g_slow = torch.stack([torch.as_tensor(d[0]) for d in got]).to(device, torch.float32)
    g_fast = torch.stack([torch.as_tensor(d[1]) for d in got]).to(device, torch.float32)
    return g_slow.contiguous(), g_fast.contiguous()


def _draw(cfg: DualARConfig, state: State, noise: HostNoise | None, step: torch.Tensor,
          draws: Draws):
    if noise is not None:
        return _host_draws(noise, step, draws, step.device)
    return default_draws(cfg, state["noise_key"], step)


def init_state(params: Params, cfg: DualARConfig, batch: int,
               max_seq_len: int | None = None, window: int = WINDOW) -> State:
    """Fresh decode state on the parameters' device: zero KV cache in the
    parameters' dtype (sharded on their mesh), zero penalty window, step 0."""
    norm = params["norm"]
    dev = norm.device
    K1 = 1 + cfg.num_codebooks
    return {
        "kv": dual_ar.init_kv_cache(cfg, batch, max_seq_len, norm.dtype, device=dev,
                                    mesh=mesh_of(params)),
        "frame": torch.zeros((batch, K1), dtype=torch.int32, device=dev),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
        "prev": torch.zeros((batch, K1, window), dtype=torch.int32, device=dev),
        "step": torch.zeros((batch,), dtype=torch.int32, device=dev),
        "done": torch.zeros((batch,), dtype=torch.bool, device=dev),
        "sampling": torch.ones((3, batch, 1), dtype=torch.float32, device=dev),
        "noise_key": torch.zeros((batch,), dtype=torch.int64, device=dev),
    }


def reset_state(state: State) -> State:
    """Return ``state`` to :func:`init_state`'s values, in place."""
    for t in (*state["kv"].values(), state["frame"], state["pos"], state["prev"],
              state["step"], state["done"], state["noise_key"]):
        t.zero_()
    state["sampling"].fill_(1.0)
    return state


@torch.no_grad()
def resize_cache(state: State, new: State) -> State:
    """Move ``state`` into ``new``, a state of the same batch with another
    KV allocation, in place (a captured decode graph holds ``new``'s
    addresses, so a fresh dict would leave it replaying stale memory): the
    KV rows below both lengths are copied, the rows above them zeroed, and
    every other field copied as it is, positions clamped into the new
    allocation.  When shrinking, the caller must keep every live row below
    the new length; a done row may sit past it, and the clamp keeps its
    frames' cache writes inside (the JAX package leaves that to XLA's
    clamped dynamic-slice writes).  Returns ``new``."""
    S = new["kv"]["k"].shape[3]
    n = min(state["kv"]["k"].shape[3], S)
    for k in ("k", "v"):
        new["kv"][k][:, :, :, :n].copy_(state["kv"][k][:, :, :, :n])
        new["kv"][k][:, :, :, n:].zero_()
    for k, v in state.items():
        if k != "kv":
            new[k].copy_(v)
    new["pos"].clamp_(max=S - 1)
    return new


def mark_done(state: State, mask: torch.Tensor) -> None:
    """Force-finish the slots of ``mask`` (B,) bool, in place."""
    state["done"] |= mask


def set_sampling(state: State, temperature, top_p, repetition_penalty) -> None:
    """Write the sampling parameters (scalars or per-stream values) into the
    state's (B, 1) columns."""
    for col, v in zip(state["sampling"], (temperature, top_p, repetition_penalty)):
        if isinstance(v, torch.Tensor):
            col.copy_(v.reshape(-1, 1).expand_as(col))
        else:
            col.fill_(float(v))


def set_noise(state: State, noise) -> HostNoise | None:
    """Load a :class:`GumbelNoise`'s slot keys into ``state["noise_key"]``
    (no host-device sync) and return None; any other source is returned,
    to be drawn per frame on the host."""
    if not isinstance(noise, GumbelNoise):
        return noise
    keys = state["noise_key"]
    for b, k in enumerate(noise.slot_keys(range(keys.shape[0]))):
        keys[b].fill_(k)
    return None


def penalty_column(prev: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
    """The window column the slow-token penalty reads: slot 0 while
    ``step < W`` (the step-0 frame, zeros before it is written), else the
    oldest frame, slot ``step % W``.  Returns (B, 1+K), gathered on the
    device."""
    B, K1, W = prev.shape
    col = torch.where(step < W, 0, step % W).long()
    return prev.gather(2, col[:, None, None].expand(B, K1, 1))[:, :, 0].contiguous()


def _fast_loop(params: Params, cfg: DualARConfig, rope: Params, rt: Route, h_fast, a,
               prev_rows, g_fast, sampling) -> torch.Tensor:
    """The residual books on plain PyTorch: a fresh fast cache, position 0 on
    the projected hidden (its logits dropped), then one ``fast_step`` and
    one ``sample`` per book.  Returns (B, K-1) int32."""
    temp, tp, rep = sampling
    dt = params["norm"].dtype
    Vr = cfg.residual_codebook_size
    cache = dual_ar.new_fast_cache(params, cfg, h_fast.shape[0])
    dual_ar.fast_step(params, cfg, rope, h_fast, 0, cache)
    code, codes = a, []
    for cb in range(1, cfg.num_codebooks):
        emb = qgather(params["fast_embeddings"], code.long(), dt)[:, None]
        logits = dual_ar.fast_step(params, cfg, rope, emb, cb, cache)[:, -1, :Vr]
        code = sample(g_fast[:, cb - 1], logits, temp, tp, rep, prev_rows[:, cb - 1],
                      top_k=rt.res_k, approx=rt.approx)
        codes.append(code)
    return torch.stack(codes, dim=1)


def _sample_frame(params: Params, cfg: DualARConfig, ids: TokenIds, rope: Params, rt: Route,
                  gumbel, hidden_last, logits, sampling, prev_col, prev_rows,
                  skip=None) -> torch.Tensor:
    """Sample one (B, 1+K) frame: the slow token, then the residual codes,
    each on the route ``rt`` gives it."""
    g_slow, g_fast = gumbel
    temp, tp, rep = sampling
    if rt.sampler:
        token = sampler_kernel.sample_slow(logits.float().contiguous(), prev_col, g_slow,
                                           temp, tp, rep, skip)
    else:
        token = sample(g_slow, logits, temp, tp, rep, prev_col, top_k=rt.top_k,
                       approx=rt.approx)
    h_fast = dual_ar.project_fast_in(params, hidden_last).to(params["norm"].dtype)
    a = torch.clamp(token - ids.semantic_begin, 0, cfg.codebook_size - 1).to(torch.int32)
    if rt.fast:
        codes, _ = fast_decoder.fast_decode_frame(
            params, cfg, rope["fast"], h_fast[:, 0], a, prev_rows, g_fast, temp, tp, rep,
            window=prev_rows.shape[-1], skip=skip)
    else:
        codes = _fast_loop(params, cfg, rope, rt, h_fast, a, prev_rows, g_fast, sampling)
    return torch.cat([token[:, None], a[:, None], codes], dim=1).to(torch.int32)


@torch.no_grad()
def prefill(params: Params, rope: Params, state: State, prompt: torch.Tensor,
            lengths: torch.Tensor, noise, temperature, top_p, repetition_penalty,
            *, cfg: DualARConfig, ids: TokenIds, kv_bucket: int | None = None,
            top_k: int = -1, approx: bool = False, fast_kernel: bool = True):
    """Whole-prompt forward at positions ``state.pos + [0, Tb)`` plus the
    first frame, with no penalty.  ``prompt`` (B, 1+K, Tb) is right-padded;
    ``lengths`` (B,) are the real lengths.  ``kv_bucket`` bounds the live
    cache prefix (0 for a fresh sequence, None reads it all).  Loads the
    sampling parameters and the noise keys into the state for the frames
    that follow.  ``top_k``, ``approx`` and ``fast_kernel`` choose the
    frame's route (:func:`route`).  Returns (state, frame (B, 1+K))."""
    global prefill_eager
    set_sampling(state, temperature, top_p, repetition_penalty)
    host_noise = set_noise(state, noise)
    frame = prefill_body(params, cfg, ids, rope, state, prompt, lengths, host_noise,
                         kv_bucket=kv_bucket, top_k=top_k, approx=approx,
                         fast_kernel=fast_kernel)
    prefill_eager += 1
    return state, frame


def prefill_body(params: Params, cfg: DualARConfig, ids: TokenIds, rope: Params, state: State,
                 prompt: torch.Tensor, lengths: torch.Tensor, noise: HostNoise | None = None,
                 *, kv_bucket: int | None, top_k: int = -1, approx: bool = False,
                 fast_kernel: bool = True) -> torch.Tensor:
    """:func:`prefill` after the sampling columns and noise keys are in the
    state: device tensors in and out, nothing read back (with ``noise``
    None, the default draws), so a CUDA graph can hold it.  Returns the
    frame (B, 1+K)."""
    B, _, Tb = prompt.shape
    dev = prompt.device
    S = state["kv"]["k"].shape[3]
    offset = state["pos"].long()
    R = S if kv_bucket is None else kv_bucket
    positions = offset[:, None] + torch.arange(Tb, device=dev)[None]
    zero = torch.zeros((), device=dev)
    cache_bias = None
    if R > 0:
        k_pos = torch.arange(R, device=dev)
        cache_bias = torch.where(k_pos[None, None, None, :] < offset[:, None, None, None],
                                 zero, NEG_INF).expand(B, 1, Tb, R)
    t_idx = torch.arange(Tb, device=dev)
    block_bias = torch.where(t_idx[None, :] <= t_idx[:, None], zero, NEG_INF)[None, None]

    hidden = dual_ar.slow_forward(params, cfg, ids, rope, prompt, positions, state["kv"],
                                  cache_bias, block_bias, read_len=kv_bucket)
    last = (lengths.long() - 1).to(dev)
    hidden_last = hidden[torch.arange(B, device=dev), last][:, None]  # (B, 1, D)
    logits = dual_ar.lm_logits(params, cfg, hidden_last)[:, -1]
    step = torch.full((B,), PREFILL_STEP, dtype=torch.int32, device=dev)
    temp, tp, _ = state["sampling"]
    no_penalty = torch.ones_like(temp)  # exact no-op: prefill has no penalty
    W = state["prev"].shape[2]
    rt = route(cfg, params, B, W, top_k=top_k, approx=approx, fast_kernel=fast_kernel)
    zeros = functools.partial(torch.zeros, dtype=torch.int32, device=dev)
    frame = _sample_frame(params, cfg, ids, rope, rt,
                          _draw(cfg, state, noise, step, rt.draws(cfg)),
                          hidden_last, logits, (temp, tp, no_penalty), zeros((B, 1)),
                          zeros((B, cfg.num_codebooks - 1, W)))
    state["frame"].copy_(frame)
    state["pos"].copy_(offset + lengths.long().to(dev))
    state["done"] |= frame[:, 0] == ids.im_end
    return frame


class _Ring:
    """A chunk's output buffers, (B, n, 1+K) frames and (B, n) emitted
    flags, written at a device counter that each frame advances."""

    def __init__(self, batch: int, n: int, width: int, device):
        self.frames = torch.zeros((batch, n, width), dtype=torch.int32, device=device)
        self.emitted = torch.zeros((batch, n), dtype=torch.bool, device=device)
        self.t = torch.zeros((1,), dtype=torch.int64, device=device)

    def record(self, frame: torch.Tensor, emitted: torch.Tensor) -> None:
        self.frames.index_copy_(1, self.t, frame[:, None])
        self.emitted.index_copy_(1, self.t, emitted[:, None])
        self.t.add_(1)


def _slow_step(params: Params, cfg: DualARConfig, ids: TokenIds, rope: Params, state: State,
               rt: Route, kv_bucket: int | None, skip):
    """The slow stack for one token per stream on the route ``rt`` gives it,
    each stream's K/V row written at its position (kept as it was under a
    set ``skip``).  Returns (hidden (B, 1, D), logits (B, V)) in the
    parameters' dtype."""
    kv, pos, last = state["kv"], state["pos"], state["frame"]
    B = last.shape[0]
    S = kv["k"].shape[3]
    dev = pos.device
    dt = params["norm"].dtype
    if not rt.slow_stack:
        R = S if kv_bucket is None else kv_bucket
        zero = torch.zeros((), device=dev)
        # the cache is valid strictly below pos; the token is the block's self-key
        cache_bias = torch.where(torch.arange(R, device=dev)[None, None, None, :]
                                 < pos[:, None, None, None], zero, NEG_INF)
        hidden = dual_ar.slow_forward(params, cfg, ids, rope, last[:, :, None], pos[:, None],
                                      kv, cache_bias, torch.zeros((1, 1, 1, 1), device=dev),
                                      read_len=kv_bucket, skip=skip)
        return hidden, dual_ar.lm_logits(params, cfg, hidden)[:, -1]
    x_emb = dual_ar.embed_inputs(params, cfg, ids, last[:, :, None])
    hidden, new_k, new_v, logits = slow_stack.slow_stack_step(
        params, cfg, rope["slow"], x_emb[:, 0], kv, pos,
        read_len=S if kv_bucket is None else kv_bucket, skip=skip)
    # each stream writes its K/V row at its own position
    b_idx, p_idx = torch.arange(B, device=dev), pos.long()
    for cache, new in ((kv["k"], new_k), (kv["v"], new_v)):
        row = new[:, :, :, 0].transpose(0, 1).to(cache.dtype)
        if skip is not None:
            row = torch.where(skip, cache[:, b_idx, :, p_idx], row)
        cache[:, b_idx, :, p_idx] = row
    hidden = hidden.to(dt)
    if logits is None:  # the kernel ran without a head: the untied one follows
        return hidden, dual_ar.lm_logits(params, cfg, hidden)[:, -1]
    return hidden, logits.to(dt)


def decode_frame(params: Params, cfg: DualARConfig, ids: TokenIds, rope: Params,
                 state: State, noise: HostNoise | None = None, *,
                 kv_bucket: int | None = None, skip_done: bool = False,
                 ring: _Ring | None = None, top_k: int = -1, approx: bool = False,
                 fast_kernel: bool = True):
    """One decode frame, in place on the state's tensors; records the frame
    and its emitted flags in ``ring``.  ``noise`` None draws the default
    noise from ``state["noise_key"]``; ``skip_done`` enables the all-done
    skip; ``top_k``, ``approx`` and ``fast_kernel`` choose the route
    (:func:`route`).  Returns (frame (B, 1+K), emitted (B,))."""
    pos, prev, step, done = (state[k] for k in ("pos", "prev", "step", "done"))
    last = state["frame"]
    B, K1 = last.shape
    S = state["kv"]["k"].shape[3]
    W = prev.shape[2]
    skip = done.all() if skip_done else None
    rt = route(cfg, params, B, W, top_k=top_k, approx=approx, fast_kernel=fast_kernel)

    hidden, logits = _slow_step(params, cfg, ids, rope, state, rt, kv_bucket, skip)
    frame = _sample_frame(params, cfg, ids, rope, rt,
                          _draw(cfg, state, noise, step, rt.draws(cfg)), hidden, logits,
                          state["sampling"], penalty_column(prev, step),
                          prev[:, 2:, :].contiguous(), skip)

    # done streams hold their frame and position; live ones advance, clamped.
    # A skipped frame has every stream done, so these leave the state as it was.
    emitted = ~done
    new_frame = torch.where(done[:, None], last, frame)
    new_pos = torch.where(done, pos, torch.clamp(pos + 1, max=S - 1))
    new_done = done | (frame[:, 0] == ids.im_end)
    # the frame goes into each slot's circular window at step % W
    slot = (step.long() % W)[:, None, None].expand(B, K1, 1)
    col = frame[:, :, None]
    new_step = step + 1
    if skip is not None:
        col = torch.where(skip, prev.gather(2, slot), col)
        new_step = torch.where(skip, step, new_step)
        frame = torch.where(skip, last, frame)
    prev.scatter_(2, slot, col)
    step.copy_(new_step)
    last.copy_(new_frame)
    pos.copy_(new_pos)
    done.copy_(new_done)
    if ring is not None:
        ring.record(frame, emitted)
    return frame, emitted


@torch.no_grad()
def decode_chunk(params: Params, rope: Params, state: State, noise, temperature,
                 top_p, repetition_penalty, *, cfg: DualARConfig, ids: TokenIds,
                 num_frames: int, kv_bucket: int | None = None, early_exit: bool = False,
                 top_k: int = -1, approx: bool = False, fast_kernel: bool = True):
    """Decode ``num_frames`` frames eagerly.  Returns (state, frames (B, n,
    1+K), emitted (B, n)); ``emitted[b, t]`` is False for frames after
    stream b hit EOS (the EOS frame itself is emitted).  With ``early_exit``
    (always for B > 1) a frame after every stream is done is skipped.
    ``top_k``, ``approx`` and ``fast_kernel`` choose the route."""
    global eager_frames
    set_sampling(state, temperature, top_p, repetition_penalty)
    host_noise = set_noise(state, noise)
    B, K1 = state["frame"].shape
    ring = _Ring(B, num_frames, K1, state["frame"].device)
    for _ in range(num_frames):
        decode_frame(params, cfg, ids, rope, state, host_noise, kv_bucket=kv_bucket,
                     skip_done=B > 1 or early_exit, ring=ring, top_k=top_k, approx=approx,
                     fast_kernel=fast_kernel)
        eager_frames += 1
    return state, ring.frames, ring.emitted


@torch.no_grad()
def prefill_chunk(params: Params, rope: Params, state: State, prompt: torch.Tensor,
                  lengths: torch.Tensor, noise, temperature, top_p,
                  repetition_penalty, *, cfg: DualARConfig, ids: TokenIds, num_frames: int,
                  kv_bucket_prefill: int | None = None, kv_bucket: int | None = None,
                  top_k: int = -1, approx: bool = False, fast_kernel: bool = True):
    """Prefill plus the first ``num_frames`` decode frames (straight-line
    for B = 1).  Returns (state, frames (B, 1+num_frames, 1+K), emitted)
    with frame 0 the prefill frame, always emitted."""
    opts = dict(top_k=top_k, approx=approx, fast_kernel=fast_kernel)
    state, first = prefill(params, rope, state, prompt, lengths, noise, temperature, top_p,
                           repetition_penalty, cfg=cfg, ids=ids, kv_bucket=kv_bucket_prefill,
                           **opts)
    B = first.shape[0]
    ones = torch.ones((B, 1), dtype=torch.bool, device=first.device)
    if num_frames == 0:
        return state, first[:, None], ones
    state, frames, emitted = decode_chunk(
        params, rope, state, noise, temperature, top_p, repetition_penalty,
        cfg=cfg, ids=ids, num_frames=num_frames, kv_bucket=kv_bucket, **opts)
    return (state, torch.cat([first[:, None], frames], dim=1),
            torch.cat([ones, emitted], dim=1))


class DecodeGraph:
    """One :func:`decode_frame` captured in a CUDA graph on ``state`` and
    replayed once per frame.

    The graph holds the addresses of everything the frame reads and writes:
    the state's tensors (updated in place), the KV cache, the sampling
    columns and noise keys (loaded by :func:`prefill`), the parameters, the
    kernels' prepared weights and scratch (with or without the slow head),
    and its own output ring of ``capacity`` frames with the device counter
    that places each frame.  ``options`` are :func:`decode_frame`'s
    ``top_k``, ``approx`` and ``fast_kernel``: the route is fixed at
    capture.  So it serves
    any state values and any ``num_frames``, but only this state object.
    Capture runs one eager frame first (the kernels' first-use setup),
    then restores the state.  A failure raises; there is no eager fallback.
    Neither that frame nor the capture counts in the kernels' launch
    counts; each replay adds the launches it makes.
    """

    def __init__(self, params: Params, cfg: DualARConfig, ids: TokenIds, rope: Params,
                 state: State, *, kv_bucket: int | None, skip_done: bool, capacity: int,
                 **options):
        B, K1 = state["frame"].shape
        self.ring = _Ring(B, capacity, K1, state["frame"].device)
        frame = functools.partial(decode_frame, params, cfg, ids, rope, state, None,
                                  kv_bucket=kv_bucket, skip_done=skip_done, ring=self.ring,
                                  **options)
        self.graph, _, self._launches = _capture(state, frame)
        # what the graph reads must outlive it
        self._keep = (params, rope, slow_stack._prepared, fast_decoder._prepared)

    def run(self, num_frames: int):
        """Replay ``num_frames`` frames.  Returns (frames (B, n, 1+K),
        emitted (B, n)), copies on the device."""
        global graph_replays
        frames, emitted = [], []
        cap = self.ring.frames.shape[1]
        for n in [min(cap, num_frames - s) for s in range(0, num_frames, cap)] or [0]:
            self.ring.t.zero_()
            for _ in range(n):
                self.graph.replay()
            graph_replays += n
            add_launches(k * n for k in self._launches)
            frames.append(self.ring.frames[:, :n].clone())
            emitted.append(self.ring.emitted[:, :n].clone())
        if len(frames) == 1:
            return frames[0], emitted[0]
        return torch.cat(frames, dim=1), torch.cat(emitted, dim=1)


class PrefillGraph:
    """:func:`prefill_body` at B = 1 captured in a CUDA graph on ``state``
    at prompt bucket ``bucket`` and cache read bound ``kv_bucket``, and
    replayed once per prefill.

    The graph reads the prompt from static buffers, ``prompt`` (1, 1+K,
    bucket) and ``lengths`` (1,), which :meth:`run` rewrites whole, zero
    padding included, before each replay, and it reads the state's
    position (the offset a forked prefix left), sampling columns and noise
    keys, loaded before the replay.  It launches the kernels the eager
    prefill launches, on the same inputs, on the route ``options`` fix at
    capture.  Its temporaries come from ``pool``, a graph memory pool that
    the graphs of one owner share, replayed one at a time in stream order.
    Capture, warm-up and launch counts as in :class:`DecodeGraph`."""

    def __init__(self, params: Params, cfg: DualARConfig, ids: TokenIds, rope: Params,
                 state: State, bucket: int, *, kv_bucket: int | None, pool=None, **options):
        dev = state["frame"].device
        self.prompt = torch.zeros((1, 1 + cfg.num_codebooks, bucket), dtype=torch.int32,
                                  device=dev)
        self.lengths = torch.ones((1,), dtype=torch.int32, device=dev)
        body = functools.partial(prefill_body, params, cfg, ids, rope, state, self.prompt,
                                 self.lengths, kv_bucket=kv_bucket, **options)
        self.graph, self._frame, self._launches = _capture(state, body, pool)
        self._keep = (params, rope, slow_stack._prepared, fast_decoder._prepared)

    def run(self, prompt: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """One prefill of ``prompt`` (1, 1+K, bucket) with real length
        ``lengths`` (1,), both on the device.  Returns the frame (1, 1+K), a
        copy of the graph's output made right after the replay."""
        global prefill_replays
        self.prompt.copy_(prompt)
        self.lengths.copy_(lengths)
        self.graph.replay()
        prefill_replays += 1
        add_launches(self._launches)
        return self._frame.clone()


def eager_because(params: Params, state: State, batch: int, noise, *,
                  prefill: bool) -> str | None:
    """Why work on ``state`` must run eagerly, or None where a captured
    graph can hold it: parameters on a mesh (a frame spans devices) or a
    state off the card; for a prefill also more than one row or a host noise
    source (drawn per call on the host).  :class:`Runner` asks this alone."""
    if isinstance(params, MeshParams):
        return "mesh"
    if prefill and batch != 1:
        return "batch"
    if prefill and not isinstance(noise, GumbelNoise):
        return "host noise"
    if state["frame"].device.type != "cuda":
        return "device"
    return None


class Runner:
    """One owner's prefills and decode chunks (the engine's, a serving
    pool's): the persistent states it hands out, the graphs captured on
    them, and the choice of graph or eager loop (:func:`eager_because`).

    - :meth:`state`: one state per (batch, rows, scratch), made at first use
      and reset in place when asked.  A graph holds its state's addresses
      (and keeps it alive), so a state is never replaced, and no other owner
      resets it: each owner has a runner, and so states, of its own.
    - :meth:`prefill`: a :class:`PrefillGraph` per (state, prompt bucket,
      ``kv_bucket``, cache dtype, route), all on the runner's one graph
      memory pool.
    - :meth:`decode`: a :class:`DecodeGraph` per (state, ``kv_bucket``, skip,
      route) of ``capacity`` frames, each on its own memory pool.

    Each graph is captured at first use inside a ``graph.capture`` span of
    ``metrics``; where :func:`eager_because` gives a reason, the eager
    :func:`prefill` or :func:`decode_chunk` runs instead, looked up in this
    module when called.  A state passed in must be persistent and whole:
    never a view of some rows of another state, which a graph would replay
    into whatever memory the view named at capture (``generate_batch``'s
    grouped prefill calls the eager :func:`prefill` itself).  ``window`` is
    the states' penalty window; ``options`` are :func:`route`'s."""

    def __init__(self, params: Params, cfg: DualARConfig, ids: TokenIds, rope: Params, metrics,
                 *, capacity: int, window: int = WINDOW, **options):
        self.params, self.cfg, self.ids, self.rope = params, cfg, ids, rope
        self.metrics, self.capacity, self.window, self.options = metrics, capacity, window, options
        self._states: dict[tuple, State] = {}
        self._prefills: dict[tuple, PrefillGraph] = {}
        self._decodes: dict[tuple, DecodeGraph] = {}
        self._pool = None

    def sibling(self, capacity: int) -> Runner:
        """A runner on the same parameters and route with states and graphs
        of its own, ``capacity`` frames a decode graph."""
        return Runner(self.params, self.cfg, self.ids, self.rope, self.metrics,
                      capacity=capacity, window=self.window, **self.options)

    def route(self, batch: int) -> Route:
        """The route of a frame of ``batch`` streams (:func:`route`)."""
        return route(self.cfg, self.params, batch, self.window, **self.options)

    def state(self, batch: int, rows: int, *, reset: bool = True, scratch: bool = False) -> State:
        """The persistent state of ``batch`` streams and ``rows`` cache rows,
        reset in place when ``reset`` is set.  ``scratch`` names a second
        state of that shape (a pool's admission scratch, apart from its
        decode state at one slot)."""
        key = (batch, rows, scratch)
        state = self._states.get(key)
        if state is None:
            state = self._states[key] = init_state(self.params, self.cfg, batch, rows,
                                                   self.window)
        elif reset:
            reset_state(state)
        return state

    @torch.no_grad()
    def prefill(self, state: State, prompt: torch.Tensor, lengths: torch.Tensor, noise,
                temperature, top_p, repetition_penalty, *, kv_bucket: int | None):
        """:func:`prefill` on this runner's route.  Returns (state, frame)."""
        params, cfg = self.params, self.cfg
        if eager_because(params, state, prompt.shape[0], noise, prefill=True) is not None:
            return prefill(params, self.rope, state, prompt, lengths, noise, temperature,
                           top_p, repetition_penalty, cfg=cfg, ids=self.ids,
                           kv_bucket=kv_bucket, **self.options)
        set_sampling(state, temperature, top_p, repetition_penalty)
        set_noise(state, noise)
        bucket = prompt.shape[2]
        key = (id(state), bucket, kv_bucket, state["kv"]["k"].dtype, self.route(1))
        graph = self._prefills.get(key)
        if graph is None:
            with self.metrics.span("graph.capture"):
                graph = self._prefills[key] = PrefillGraph(
                    params, cfg, self.ids, self.rope, state, bucket, kv_bucket=kv_bucket,
                    pool=self._pool, **self.options)
            # the first graph's pool is every later one's
            self._pool = graph.graph.pool()
        return state, graph.run(prompt, lengths)

    @torch.no_grad()
    def decode(self, state: State, noise, sampling, num_frames: int, *,
               kv_bucket: int | None, skip_done: bool):
        """``num_frames`` frames on ``state``.  The eager loop loads
        ``sampling`` (temperature, top-p, penalty) and ``noise``'s keys into
        the state first; a graph reads what the state holds (loaded by a
        prefill, an admission or the caller).  ``skip_done`` enables the
        all-done skip at one stream (always on above one).  Returns
        (frames (B, n, 1+K), emitted (B, n)) on the device."""
        B = state["frame"].shape[0]
        if eager_because(self.params, state, B, noise, prefill=False) is not None:
            _, frames, emitted = decode_chunk(
                self.params, self.rope, state, noise, *sampling, cfg=self.cfg, ids=self.ids,
                num_frames=num_frames, kv_bucket=kv_bucket, early_exit=skip_done,
                **self.options)
            return frames, emitted
        skip = B > 1 or skip_done
        key = (id(state), kv_bucket, skip, self.route(B))
        graph = self._decodes.get(key)
        if graph is None:
            with self.metrics.span("graph.capture"):
                graph = self._decodes[key] = DecodeGraph(
                    self.params, self.cfg, self.ids, self.rope, state, kv_bucket=kv_bucket,
                    skip_done=skip, capacity=self.capacity, **self.options)
        return graph.run(num_frames)


def _capture(state: State, fn, pool=None):
    """``fn`` captured in a CUDA graph on ``state``: one eager call on a
    side stream first (the kernels' first-use setup), then the capture on
    it (from ``pool`` when given), then the state restored.  The host waits
    for nothing: ``torch.cuda.graph`` would first synchronize the device
    and empty the allocator's caches, which the capture does not need and
    which, mid-serving, waits for the work in flight and makes every later
    allocation anew.  Neither call counts in the kernels' launch counters.
    Returns (the graph, ``fn``'s output in the capture, the launches a
    replay makes in :func:`launch_counts` order)."""
    dev = state["frame"].device
    if dev.type != "cuda":
        raise ValueError("a captured graph needs its state on a CUDA device")
    saved = [t.clone() for t in _tensors(state)]
    counts = launch_counts()
    with torch.no_grad():
        side = _side_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            fn()
            before = launch_counts()
            graph.capture_begin(pool=pool)
            try:
                out = fn()
            finally:
                graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(side)
        launches = [n - m for n, m in zip(launch_counts(), before)]
        for (m, name), n in zip(_COUNTERS, counts):
            setattr(m, name, n)
        for t, old in zip(_tensors(state), saved):
            t.copy_(old)
    return graph, out, launches


@functools.cache
def _side_stream(dev: torch.device) -> torch.cuda.Stream:
    """The stream captures run on, one per device: what a warm-up call
    frees stays cached for the next capture's."""
    return torch.cuda.Stream(dev)


# each kernel's launch counter: (module, attribute)
_COUNTERS = ((sampler_kernel, "launches"), (slow_stack, "launches"),
             (slow_stack, "headless_launches"), (fast_decoder, "launches"),
             (fast_decoder, "launches_spread"), (slow_stack, "launches_qk"))


def launch_counts() -> list[int]:
    """Every kernel counter of ``_COUNTERS``, in order."""
    return [getattr(m, name) for m, name in _COUNTERS]


def add_launches(deltas) -> None:
    """Add a replay's launches (``launch_counts()`` order) to the counters."""
    for (m, name), k in zip(_COUNTERS, deltas):
        setattr(m, name, getattr(m, name) + k)


def _tensors(state: State) -> list[torch.Tensor]:
    return [*state["kv"].values(), *(state[k] for k in state if k != "kv")]
