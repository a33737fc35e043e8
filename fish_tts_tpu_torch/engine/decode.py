"""The DualAR decode engine: prefill plus chunked decode on the kernel path.

Port of ``fish_tts_tpu/engine/decode.py`` for the path that runs the three
kernels (the JAX package's ``fast_kernel=True`` route):

- ``prefill``: the whole (bucket-padded) prompt through the plain PyTorch
  transformer stack, writing the KV cache, then the first frame sampled
  through the sampler and fast-decoder kernels;
- ``decode_frame``: one frame on the state's device tensors alone: embed
  the last frame, run the slow-stack kernel against the read-only cache,
  write the returned K/V rows at each stream's position, sample the next
  frame, and update the state in place.  It reads nothing back to the host,
  so a CUDA graph can hold it;
- ``decode_chunk``: ``decode_frame`` in an eager loop, on either device
  (the CPU's route, and the reference the graph is held against);
- ``DecodeGraph``: one ``decode_frame`` captured in a CUDA graph on a
  persistent state and replayed once per frame (the engine's route on the
  card): the host pays one graph launch per frame and reads nothing back.

All-done skip, as the reference's per-frame ``lax.cond``: with ``B > 1`` or
``early_exit`` each frame computes ``skip = done.all()`` on the device; the
kernels return at once when it is set, and every state update is
``where(skip, old, new)``.  A skipped frame leaves the state as it was,
emits ``state["frame"]`` and marks nothing emitted.  Prefill's first chunk
keeps the straight-line route.

Replicated reference quirks, as in the JAX package: the slow-token penalty
reads one window *column* (:func:`penalty_column`); the fast position 0
output is discarded; the prefill frame is not recorded in the penalty
window; ``a = token - semantic_begin`` is clamped into the codebook.

RNG.  The default source (:class:`GumbelNoise`) is counter-based: lane i
of slot b at step s draws from a 32-bit integer hash of (seed, slot, step,
lane) computed with torch integer ops on the device, so frames depend on
neither the batch nor how decode is cut into chunks, and the CPU and the
card draw the same bits.  A test may instead pass a host source called per
(slot, step) that returns ``(g_slow (V,), g_fast (K-1, Vr))``, the draws of
the JAX kernel path; it runs only eagerly, since it reads the steps back.
The prefill frame uses step :data:`PREFILL_STEP`, which no decode step
reaches.

State is a dict of device tensors, all updated in place (a captured graph
holds their addresses): ``kv`` {"k", "v"} (L, B, Hkv, S, Dh), ``frame``
(B, 1+K), ``pos`` (B,) int32, ``prev`` (B, 1+K, W) penalty window, ``step``
(B,) int32, ``done`` (B,) bool, ``sampling`` (3, B, 1) f32 (temperature,
top-p and penalty columns) and ``noise_key`` (B,) int64 (the default
source's key of each slot).
"""

from __future__ import annotations

import functools
from typing import Any, Callable

import torch

from fish_tts_tpu_torch.config import DualARConfig
from fish_tts_tpu_torch.models import dual_ar
from fish_tts_tpu_torch.models.dual_ar import Params, TokenIds
from fish_tts_tpu_torch.ops import fast_decoder, sampler_kernel, slow_stack
from fish_tts_tpu_torch.ops.attention import NEG_INF

WINDOW = 16  # default repetition-penalty window
PREFILL_STEP = 0x7FFFFFFF  # noise step of the prefill frame

# Frames run by the eager loop and frames replayed from a captured graph,
# for showing which route a run took.
eager_frames = 0
graph_replays = 0

State = dict[str, Any]
HostNoise = Callable[[int, int], tuple[torch.Tensor, torch.Tensor]]

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
    ``step`` (B,), on their device: ((B, V), (B, K-1, Vr)) f32."""
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


def _host_draws(noise: HostNoise, step: torch.Tensor, device):
    """A host source's draws of every slot at its own step (reads the steps
    back, so it runs only eagerly): ((B, V), (B, K-1, Vr))."""
    draws = [noise(b, s) for b, s in enumerate(step.tolist())]
    g_slow = torch.stack([torch.as_tensor(d[0]) for d in draws]).to(device, torch.float32)
    g_fast = torch.stack([torch.as_tensor(d[1]) for d in draws]).to(device, torch.float32)
    return g_slow.contiguous(), g_fast.contiguous()


def _draw(cfg: DualARConfig, state: State, noise: HostNoise | None, step: torch.Tensor):
    if noise is not None:
        return _host_draws(noise, step, step.device)
    return default_draws(cfg, state["noise_key"], step)


def init_state(params: Params, cfg: DualARConfig, batch: int,
               max_seq_len: int | None = None, window: int = WINDOW) -> State:
    """Fresh decode state on the parameters' device: zero KV cache in the
    parameters' dtype, zero penalty window, step 0."""
    norm = params["norm"]
    dev = norm.device
    K1 = 1 + cfg.num_codebooks
    return {
        "kv": dual_ar.init_kv_cache(cfg, batch, max_seq_len, norm.dtype, device=dev),
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


def _sample_frame(params: Params, cfg: DualARConfig, ids: TokenIds, rope: Params,
                  gumbel, hidden_last, logits, sampling, prev_col, prev_rows,
                  skip=None) -> torch.Tensor:
    """Sample one (B, 1+K) frame: the slow token through the sampler kernel,
    then the residual codes through the fast-decoder kernel."""
    g_slow, g_fast = gumbel
    temp, tp, rep = sampling
    token = sampler_kernel.sample_slow(logits.float().contiguous(), prev_col, g_slow,
                                       temp, tp, rep, skip)
    h_fast = dual_ar.project_fast_in(params, hidden_last).to(params["norm"].dtype)
    a = torch.clamp(token - ids.semantic_begin, 0, cfg.codebook_size - 1).to(torch.int32)
    codes, _ = fast_decoder.fast_decode_frame(
        params, cfg, rope["fast"], h_fast[:, 0], a, prev_rows, g_fast, temp, tp, rep,
        window=prev_rows.shape[-1], skip=skip)
    return torch.cat([token[:, None], a[:, None], codes], dim=1).to(torch.int32)


@torch.no_grad()
def prefill(params: Params, rope: Params, state: State, prompt: torch.Tensor,
            lengths: torch.Tensor, noise, temperature, top_p, repetition_penalty,
            *, cfg: DualARConfig, ids: TokenIds, kv_bucket: int | None = None):
    """Whole-prompt forward at positions ``state.pos + [0, Tb)`` plus the
    first frame, with no penalty.  ``prompt`` (B, 1+K, Tb) is right-padded;
    ``lengths`` (B,) are the real lengths.  ``kv_bucket`` bounds the live
    cache prefix (0 for a fresh sequence, None reads it all).  Loads the
    sampling parameters and the noise keys into the state for the frames
    that follow.  Returns (state, frame (B, 1+K))."""
    B, _, Tb = prompt.shape
    dev = prompt.device
    set_sampling(state, temperature, top_p, repetition_penalty)
    host_noise = set_noise(state, noise)
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
    zeros = functools.partial(torch.zeros, dtype=torch.int32, device=dev)
    frame = _sample_frame(params, cfg, ids, rope, _draw(cfg, state, host_noise, step),
                          hidden_last, logits, (temp, tp, no_penalty), zeros((B, 1)),
                          zeros((B, cfg.num_codebooks - 1, W)))
    state["frame"].copy_(frame)
    state["pos"].copy_(offset + lengths.long().to(dev))
    state["done"] |= frame[:, 0] == ids.im_end
    return state, frame


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


def decode_frame(params: Params, cfg: DualARConfig, ids: TokenIds, rope: Params,
                 state: State, noise: HostNoise | None = None, *,
                 kv_bucket: int | None = None, skip_done: bool = False,
                 ring: _Ring | None = None):
    """One decode frame, in place on the state's tensors; records the frame
    and its emitted flags in ``ring``.  ``noise`` None draws the default
    noise from ``state["noise_key"]``; ``skip_done`` enables the all-done
    skip.  Returns (frame (B, 1+K), emitted (B,))."""
    kv, pos, prev, step, done = (state[k] for k in ("kv", "pos", "prev", "step", "done"))
    last = state["frame"]
    B, K1 = last.shape
    S = kv["k"].shape[3]
    W = prev.shape[2]
    dev = pos.device
    skip = done.all() if skip_done else None

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
    dt = params["norm"].dtype
    frame = _sample_frame(params, cfg, ids, rope, _draw(cfg, state, noise, step),
                          hidden.to(dt), logits.to(dt), state["sampling"],
                          penalty_column(prev, step), prev[:, 2:, :].contiguous(), skip)

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
                 num_frames: int, kv_bucket: int | None = None, early_exit: bool = False):
    """Decode ``num_frames`` frames eagerly.  Returns (state, frames (B, n,
    1+K), emitted (B, n)); ``emitted[b, t]`` is False for frames after
    stream b hit EOS (the EOS frame itself is emitted).  With ``early_exit``
    (always for B > 1) a frame after every stream is done is skipped."""
    global eager_frames
    set_sampling(state, temperature, top_p, repetition_penalty)
    host_noise = set_noise(state, noise)
    B, K1 = state["frame"].shape
    ring = _Ring(B, num_frames, K1, state["frame"].device)
    for _ in range(num_frames):
        decode_frame(params, cfg, ids, rope, state, host_noise, kv_bucket=kv_bucket,
                     skip_done=B > 1 or early_exit, ring=ring)
        eager_frames += 1
    return state, ring.frames, ring.emitted


@torch.no_grad()
def prefill_chunk(params: Params, rope: Params, state: State, prompt: torch.Tensor,
                  lengths: torch.Tensor, noise, temperature, top_p,
                  repetition_penalty, *, cfg: DualARConfig, ids: TokenIds, num_frames: int,
                  kv_bucket_prefill: int | None = None, kv_bucket: int | None = None):
    """Prefill plus the first ``num_frames`` decode frames (straight-line
    for B = 1).  Returns (state, frames (B, 1+num_frames, 1+K), emitted)
    with frame 0 the prefill frame, always emitted."""
    state, first = prefill(params, rope, state, prompt, lengths, noise, temperature, top_p,
                           repetition_penalty, cfg=cfg, ids=ids, kv_bucket=kv_bucket_prefill)
    B = first.shape[0]
    ones = torch.ones((B, 1), dtype=torch.bool, device=first.device)
    if num_frames == 0:
        return state, first[:, None], ones
    state, frames, emitted = decode_chunk(
        params, rope, state, noise, temperature, top_p, repetition_penalty,
        cfg=cfg, ids=ids, num_frames=num_frames, kv_bucket=kv_bucket)
    return (state, torch.cat([first[:, None], frames], dim=1),
            torch.cat([ones, emitted], dim=1))


class DecodeGraph:
    """One :func:`decode_frame` captured in a CUDA graph on ``state`` and
    replayed once per frame.

    The graph holds the addresses of everything the frame reads and writes:
    the state's tensors (updated in place), the KV cache, the sampling
    columns and noise keys (loaded by :func:`prefill`), the kernels'
    prepared weights and scratch, and its own output ring of ``capacity``
    frames with the device counter that places each frame.  So it serves
    any state values and any ``num_frames``, but only this state object.
    Capture runs one eager frame first (the kernels' first-use setup),
    then restores the state.  A failure raises; there is no eager fallback.
    Capture launches nothing: the kernels' launch counts are taken back
    after it, and each replay adds the launches it makes.
    """

    def __init__(self, params: Params, cfg: DualARConfig, ids: TokenIds, rope: Params,
                 state: State, *, kv_bucket: int | None, skip_done: bool, capacity: int):
        dev = state["frame"].device
        if dev.type != "cuda":
            raise ValueError("DecodeGraph: the state must be on a CUDA device")
        B, K1 = state["frame"].shape
        self.ring = _Ring(B, capacity, K1, dev)
        frame = functools.partial(decode_frame, params, cfg, ids, rope, state, None,
                                  kv_bucket=kv_bucket, skip_done=skip_done, ring=self.ring)
        saved = [t.clone() for t in _tensors(state)]
        with torch.no_grad():
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                frame()
            torch.cuda.current_stream(dev).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            before = [m.launches for m in _KERNELS]
            with torch.cuda.graph(self.graph):
                frame()
            self._launches = [m.launches - n for m, n in zip(_KERNELS, before)]
            for m, n in zip(_KERNELS, self._launches):
                m.launches -= n
            for t, old in zip(_tensors(state), saved):
                t.copy_(old)
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
            for m, k in zip(_KERNELS, self._launches):
                m.launches += k * n
            frames.append(self.ring.frames[:, :n].clone())
            emitted.append(self.ring.emitted[:, :n].clone())
        if len(frames) == 1:
            return frames[0], emitted[0]
        return torch.cat(frames, dim=1), torch.cat(emitted, dim=1)


_KERNELS = (sampler_kernel, slow_stack, fast_decoder)  # modules with a launch count


def _tensors(state: State) -> list[torch.Tensor]:
    return [*state["kv"].values(), *(state[k] for k in state if k != "kv")]
