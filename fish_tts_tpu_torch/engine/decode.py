"""The DualAR decode engine: prefill plus chunked decode on the kernel path.

Port of ``fish_tts_tpu/engine/decode.py`` for the path that runs the three
kernels (the JAX package's ``fast_kernel=True`` route):

- ``prefill``: the whole (bucket-padded) prompt through the plain PyTorch
  transformer stack, writing the KV cache, then the first frame sampled
  through the sampler and fast-decoder kernels;
- ``decode_chunk``: a host loop over frames; each frame embeds the last
  frame, runs the slow-stack kernel against the read-only cache, writes the
  returned K/V rows at each stream's position, and samples the next frame.

Replicated reference quirks, as in the JAX package: the slow-token penalty
reads one window *column* (:func:`penalty_column`); the fast position 0
output is discarded; the prefill frame is not recorded in the penalty
window; ``a = token - semantic_begin`` is clamped into the codebook.

RNG.  Gumbel noise comes from a noise source called per (slot, step) that
returns ``(g_slow (V,), g_fast (K-1, Vr))``: one draw for the slow token and
one (K-1, Vr) draw for the residual books, the draws of the JAX kernel path.
The prefill frame uses step :data:`PREFILL_STEP`, which no decode step
reaches.  The default source (:class:`GumbelNoise`) seeds a generator from
(seed, slot, step), so frames do not depend on how decode is cut into
chunks.

State is a dict: ``kv`` {"k", "v"} (L, B, Hkv, S, Dh) updated in place,
``frame`` (B, 1+K), ``pos`` (B,) int32, ``prev`` (B, 1+K, W) penalty window,
``done`` (B,) bool, all on the device, and ``step`` (B,) int64 on the host
(it picks noise and window slots without a device round trip).
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from fish_tts_tpu_torch.config import DualARConfig
from fish_tts_tpu_torch.models import dual_ar
from fish_tts_tpu_torch.models.dual_ar import Params, TokenIds
from fish_tts_tpu_torch.ops import fast_decoder, sampler_kernel, slow_stack
from fish_tts_tpu_torch.ops.attention import NEG_INF
from fish_tts_tpu_torch.ops.fast_decoder import column

WINDOW = 16  # default repetition-penalty window
PREFILL_STEP = 0x7FFFFFFF  # noise step of the prefill frame
EXIT_CHECK = 8  # frames between host checks for all-done streams

State = dict[str, Any]
Noise = Callable[[int, int], tuple[torch.Tensor, torch.Tensor]]


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


def gumbel_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel samples ``-log(-log(u))`` with u kept above 0."""
    tiny = torch.finfo(u.dtype).tiny
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


class GumbelNoise:
    """Default noise source: per (slot, step) a generator on ``device``
    seeded from (seed, slot, step)."""

    def __init__(self, seed: int, cfg: DualARConfig, device):
        self.seed = int(seed)
        self.vocab = cfg.vocab_size
        self.fast_shape = (cfg.num_codebooks - 1, cfg.residual_codebook_size)
        self.device = torch.device(device)

    def __call__(self, slot: int, step: int) -> tuple[torch.Tensor, torch.Tensor]:
        key = _splitmix64(_splitmix64(_splitmix64(self.seed) ^ slot) ^ step)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(key & 0x7FFFFFFFFFFFFFFF)
        u_slow = torch.rand(self.vocab, generator=gen, device=self.device)
        u_fast = torch.rand(self.fast_shape, generator=gen, device=self.device)
        return gumbel_from_uniform(u_slow), gumbel_from_uniform(u_fast)


def frame_noise(noise: Noise, steps, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Stack the draws of every slot at its own step: ((B, V), (B, K-1, Vr))."""
    draws = [noise(b, int(s)) for b, s in enumerate(steps)]
    g_slow = torch.stack([torch.as_tensor(d[0]) for d in draws]).to(device, torch.float32)
    g_fast = torch.stack([torch.as_tensor(d[1]) for d in draws]).to(device, torch.float32)
    return g_slow.contiguous(), g_fast.contiguous()


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
        "step": np.zeros((batch,), np.int64),
        "done": torch.zeros((batch,), dtype=torch.bool, device=dev),
    }


def penalty_column(prev: torch.Tensor, step) -> torch.Tensor:
    """The window column the slow-token penalty reads: slot 0 while
    ``step < W`` (the step-0 frame, zeros before it is written), else the
    oldest frame, slot ``step % W``.  Returns (B, 1+K)."""
    W = prev.shape[2]
    step = np.asarray(step)
    col = np.where(step < W, 0, step % W)
    idx = torch.as_tensor(col, device=prev.device)
    return prev[torch.arange(prev.shape[0], device=prev.device), :, idx].contiguous()


def _sample_frame(params: Params, cfg: DualARConfig, ids: TokenIds, rope: Params,
                  gumbel, hidden_last, logits, temperature, top_p, repetition_penalty,
                  prev, step, window: int = WINDOW) -> torch.Tensor:
    """Sample one (B, 1+K) frame: the slow token through the sampler kernel,
    then the residual codes through the fast-decoder kernel.  ``prev`` None
    (prefill) means no penalty."""
    B = logits.shape[0]
    dev = logits.device
    g_slow, g_fast = gumbel
    temp = column(temperature, B, dev)
    tp = column(top_p, B, dev)
    if prev is None:
        prev_col = torch.zeros((B, 1), dtype=torch.int32, device=dev)
        rep = column(1.0, B, dev)  # exact no-op: prefill has no penalty
        prev_rows = torch.zeros((B, cfg.num_codebooks - 1, window), dtype=torch.int32,
                                device=dev)
    else:
        prev_col = penalty_column(prev, step)
        rep = column(repetition_penalty, B, dev)
        prev_rows = prev[:, 2:, :].contiguous()  # row cb+1 per residual step cb
    token = sampler_kernel.sample_slow(logits.float().contiguous(), prev_col, g_slow,
                                       temp, tp, rep)
    h_fast = dual_ar.project_fast_in(params, hidden_last).to(params["norm"].dtype)
    a = torch.clamp(token - ids.semantic_begin, 0, cfg.codebook_size - 1).to(torch.int32)
    codes, _ = fast_decoder.fast_decode_frame(
        params, cfg, rope["fast"], h_fast[:, 0], a, prev_rows, g_fast, temp, tp, rep,
        window=prev_rows.shape[-1])
    return torch.cat([token[:, None], a[:, None], codes], dim=1).to(torch.int32)


@torch.no_grad()
def prefill(params: Params, rope: Params, state: State, prompt: torch.Tensor,
            lengths: torch.Tensor, noise: Noise, temperature, top_p, repetition_penalty,
            *, cfg: DualARConfig, ids: TokenIds, kv_bucket: int | None = None):
    """Whole-prompt forward at positions ``state.pos + [0, Tb)`` plus the
    first frame.  ``prompt`` (B, 1+K, Tb) is right-padded; ``lengths`` (B,)
    are the real lengths.  ``kv_bucket`` bounds the live cache prefix (0 for
    a fresh sequence, None reads it all).  Returns (state, frame (B, 1+K))."""
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
    gumbel = frame_noise(noise, [PREFILL_STEP] * B, dev)
    frame = _sample_frame(params, cfg, ids, rope, gumbel, hidden_last, logits,
                          temperature, top_p, repetition_penalty, prev=None, step=None,
                          window=state["prev"].shape[2])
    new_state = dict(state)
    new_state.update(frame=frame, pos=(offset + lengths.long().to(dev)).to(torch.int32),
                     done=state["done"] | (frame[:, 0] == ids.im_end))
    return new_state, frame


def _decode_one(params: Params, cfg: DualARConfig, ids: TokenIds, rope: Params,
                state: State, gumbel, temperature, top_p, repetition_penalty,
                kv_bucket: int | None = None):
    """One decode frame.  Returns (state, frame (B, 1+K), emitted (B,))."""
    kv = state["kv"]
    B = state["frame"].shape[0]
    S = kv["k"].shape[3]
    R = S if kv_bucket is None else kv_bucket
    pos = state["pos"]
    dev = pos.device

    x_emb = dual_ar.embed_inputs(params, cfg, ids, state["frame"][:, :, None])
    hidden, new_k, new_v, logits = slow_stack.slow_stack_step(
        params, cfg, rope["slow"], x_emb[:, 0], kv, pos, read_len=R)
    # each stream writes its K/V row at its own position, in place
    b_idx = torch.arange(B, device=dev)
    p_idx = pos.long()
    kv["k"][:, b_idx, :, p_idx] = new_k[:, :, :, 0].transpose(0, 1).to(kv["k"].dtype)
    kv["v"][:, b_idx, :, p_idx] = new_v[:, :, :, 0].transpose(0, 1).to(kv["v"].dtype)
    dt = params["norm"].dtype
    frame = _sample_frame(params, cfg, ids, rope, gumbel, hidden.to(dt), logits.to(dt),
                          temperature, top_p, repetition_penalty,
                          prev=state["prev"], step=state["step"])

    was_done = state["done"]
    emitted = ~was_done
    # record the frame in each slot's circular window at step % W
    prev = state["prev"]
    slot = torch.as_tensor(state["step"] % prev.shape[2], device=dev)
    prev[b_idx, :, slot] = frame
    new_state = {
        "kv": kv,
        "frame": torch.where(was_done[:, None], state["frame"], frame),
        # done streams hold their position; live ones advance, clamped
        "pos": torch.where(was_done, pos, torch.clamp(pos + 1, max=S - 1)),
        "prev": prev,
        "step": state["step"] + 1,
        "done": was_done | (frame[:, 0] == ids.im_end),
    }
    return new_state, frame, emitted


@torch.no_grad()
def decode_chunk(params: Params, rope: Params, state: State, noise: Noise, temperature,
                 top_p, repetition_penalty, *, cfg: DualARConfig, ids: TokenIds,
                 num_frames: int, kv_bucket: int | None = None, early_exit: bool = False):
    """Decode ``num_frames`` frames.  Returns (state, frames (B, n, 1+K),
    emitted (B, n)); ``emitted[b, t]`` is False for frames after stream b
    hit EOS (the EOS frame itself is emitted).

    With ``early_exit`` (always for B > 1) the host checks every
    :data:`EXIT_CHECK` frames whether every stream is done and then skips
    the model for the rest of the chunk.
    """
    B = state["frame"].shape[0]
    dev = state["frame"].device
    frames, emitted = [], []
    stopped = False
    for t in range(num_frames):
        if (B > 1 or early_exit) and t % EXIT_CHECK == 0 and not stopped:
            stopped = bool(state["done"].all())
        if stopped:
            frames.append(state["frame"])
            emitted.append(torch.zeros((B,), dtype=torch.bool, device=dev))
            continue
        gumbel = frame_noise(noise, state["step"], dev)
        state, frame, em = _decode_one(params, cfg, ids, rope, state, gumbel,
                                       temperature, top_p, repetition_penalty, kv_bucket)
        frames.append(frame)
        emitted.append(em)
    return state, torch.stack(frames, dim=1), torch.stack(emitted, dim=1)


@torch.no_grad()
def prefill_chunk(params: Params, rope: Params, state: State, prompt: torch.Tensor,
                  lengths: torch.Tensor, noise: Noise, temperature, top_p,
                  repetition_penalty, *, cfg: DualARConfig, ids: TokenIds, num_frames: int,
                  kv_bucket_prefill: int | None = None, kv_bucket: int | None = None):
    """Prefill plus the first ``num_frames`` decode frames.  Returns (state,
    frames (B, 1+num_frames, 1+K), emitted) with frame 0 the prefill frame,
    always emitted."""
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
