"""Slow-token sampler: penalty + exact top-p + Gumbel argmax (kernel 1).

Port of ``fish_tts_tpu/ops/sampler_kernel.py::sample_slow``.  For each row
of (B, V) logits: apply the repetition penalty over the row's W window ids
(divide positive logits, multiply negative ones; id 0 is penalized like any
other), keep the top-p upper level set ``logit >= min(hi, amax)`` with
``hi`` from 40 bisection steps over the softmax mass (``top_p >= 1`` keeps
every lane), divide by the temperature clamped at 1e-5, and return the
argmax of that plus the Gumbel noise, which the caller draws.

``sample_slow`` launches the CUDA kernel (``csrc/sampler.cu``) for CUDA
tensors and runs ``sample_slow_plain`` for CPU tensors only.  Both take an
optional ``skip`` flag, a 0-dim bool tensor on the device: when it is set
the kernel returns at once and the tokens are zeros in both versions.

``supports`` is the engine's gate, the JAX kernel's own: the kernel is the
sort-free threshold sampler (``top_k == -1``) for B <= 16; other sampler
modes run ``engine/sampling.sample``.
"""

from __future__ import annotations

import torch

from fish_tts_tpu_torch.ops import kernels

NEG = -1e30  # the Pallas kernel's mask constant
MAX_BATCH = 16
BISECT_ITERS = 40
CLOCK_STAMPS = 9  # csrc/sampler.cu kClockStamps

launches = 0  # kernel launches, for showing that a run went through it
# When set to a CUDA int32 tensor (B, 3), the kernel writes per stream the
# number of cluster-wide bisection rounds it ran, the live rows it compacted
# into one block (-1 when the live set never fit) and the levels that block
# then ran with all its threads before one warp took over.
round_counter: torch.Tensor | None = None
# When set to a CUDA int64 tensor (B, CLOCK_STAMPS), the kernel writes per
# stream the global timer (ns) of rank 0's thread 0 at its start, after the
# logits are loaded, after the softmax exchange, after the first pass, after
# the cluster rounds, after the argmax over the rows every threshold keeps,
# after the compaction, after the last bisection level and at its end (a
# part that does not run repeats the stamp before it).
phase_clock: torch.Tensor | None = None


def supports(batch: int, top_k: int) -> bool:
    """Whether the kernel serves this batch and sampler mode."""
    return 1 <= batch <= MAX_BATCH and top_k == -1


def sample_slow_plain(logits, prev_col, gumbel, temperature, top_p, repetition_penalty,
                      skip=None):
    """Plain PyTorch version.  logits/gumbel (B, V) f32, prev_col (B, W)
    int, temperature/top_p/repetition_penalty (B, 1) f32.  Returns (B,)
    int32, zeros when ``skip`` is set."""
    B, V = logits.shape
    lanes = torch.arange(V, device=logits.device)
    hit = (lanes[None, None, :] == prev_col.long()[:, :, None]).any(dim=1)
    rep = repetition_penalty
    l = torch.where(hit, torch.where(logits < 0, logits * rep, logits / rep), logits)
    amax = l.max(dim=-1, keepdim=True).values
    z = torch.log(torch.exp(l - amax).sum(dim=-1, keepdim=True)) + amax
    p = torch.exp(l - z)
    lo, hi = amax - 30.0, amax + 1.0
    zero = torch.zeros((), dtype=l.dtype, device=l.device)
    for _ in range(BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        mass = torch.where(l >= mid, p, zero).sum(dim=-1, keepdim=True)
        take_hi = mass <= top_p
        lo, hi = torch.where(take_hi, lo, mid), torch.where(take_hi, mid, hi)
    thresh = torch.minimum(hi, amax)
    thresh = torch.where(top_p >= 1.0, torch.full_like(thresh, 0.5 * NEG), thresh)
    masked = torch.where(l >= thresh, l, torch.full_like(l, NEG))
    scaled = masked / torch.clamp(temperature, min=1e-5)
    token = torch.argmax(scaled + gumbel, dim=-1).to(torch.int32)
    return token if skip is None else torch.where(skip, 0, token)


def sample_slow(logits, prev_col, gumbel, temperature, top_p, repetition_penalty, skip=None):
    """Sample one token id per row; see the module docstring.  Returns (B,)
    int32 on the logits' device."""
    if logits.device.type == "cpu":
        return sample_slow_plain(logits, prev_col, gumbel, temperature, top_p,
                                 repetition_penalty, skip)
    global launches
    B, V = logits.shape
    W = prev_col.shape[1]
    if not 1 <= B <= MAX_BATCH:
        raise ValueError(f"sample_slow: batch {B} outside 1..{MAX_BATCH}")
    kernels.require_cuda("logits", logits, torch.float32, (B, V))
    kernels.require_cuda("prev_col", prev_col, torch.int32, (B, W))
    kernels.require_cuda("gumbel", gumbel, torch.float32, (B, V))
    for name, t in (("temperature", temperature), ("top_p", top_p),
                    ("repetition_penalty", repetition_penalty)):
        kernels.require_cuda(name, t, torch.float32, (B, 1))
    extra = []
    for name, t, dtype, cols in (("round_counter", round_counter, torch.int32, 3),
                                 ("phase_clock", phase_clock, torch.int64, CLOCK_STAMPS)):
        if t is not None:
            kernels.require_cuda(name, t, dtype, (B, cols))
        extra.append(t)
    if skip is not None:
        kernels.require_cuda("skip", skip, torch.bool, ())
    # a skipped call writes nothing: its tokens are the zeros allocated here
    alloc = torch.empty if skip is None else torch.zeros
    out = alloc((B,), dtype=torch.int32, device=logits.device)
    kernels.launch("fts_sample_slow",
                   [logits, prev_col, gumbel, temperature, top_p, repetition_penalty, out,
                    *extra, skip], [B, V, W])
    launches += 1
    return out
