"""Sampling on the plain routes: repetition penalty + top-p + Gumbel-max.

The port's copy of ``fish_tts_tpu/engine/sampling.py``, for the routes the
kernel gates refuse (``sample_top_k`` of 0 or > 0, ``fast_kernel=False``,
B above the kernels' limit, and the residual books of a float model).  It
is not the sampler kernel's plain version: that is
``ops/sampler_kernel.sample_slow_plain``.

The noise is an argument, not a key: the caller draws it, and each function
reads the first lanes it needs (the candidates' width).  As in the JAX
package:

- ``top_k = -1``: the sort-free threshold top-p over the whole vocabulary;
  the noise has one lane per logit.
- ``top_k = 0``: an exact full sort; the noise is added to the candidates
  in rank order.
- ``top_k > 0``: the ``top_k`` largest candidates, normalized by the full
  vocabulary's ``logsumexp``, the noise in rank order at width ``top_k``.
  ``approx=True`` names the JAX package's ``lax.approx_max_k``, a TPU
  operation that returns exactly ``lax.top_k`` elsewhere; the port runs the
  exact search for it.

Ties rank lower indices first, as ``lax.top_k`` does: candidates come from a
stable descending sort (``torch.topk`` promises no order among equal
values).

Replicated reference quirks: the penalty divides positive and multiplies
negative logits; "keep at least one" keeps only the top logit; id 0 in a
zero-padded window is penalized like any other.
"""

from __future__ import annotations

import torch

NEG_INF = float(torch.finfo(torch.float32).min)
BISECT_ITERS = 40


def _logsumexp(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.logsumexp`` over the last axis, kept: a non-finite max
    shifts by 0."""
    amax = x.max(dim=-1, keepdim=True).values
    amax = torch.where(torch.isfinite(amax), amax, torch.zeros_like(amax))
    return torch.log(torch.exp(x - amax).sum(dim=-1, keepdim=True)) + amax


def _ranked(logits: torch.Tensor, k: int):
    """The ``k`` largest values per row in descending order and their
    indices, equal values in index order."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def candidate_width(vocab: int, top_k: int) -> int:
    """The noise lanes :func:`sample` reads for ``vocab`` logits."""
    return top_k if 0 < top_k < vocab else vocab


def apply_repetition_penalty(logits: torch.Tensor, prev_idx: torch.Tensor,
                             penalty: torch.Tensor) -> torch.Tensor:
    """Penalize the ids in ``prev_idx`` (B, W): positive logits divided by
    ``penalty``, negative ones multiplied.  A repeated id gets the same value
    however often it appears."""
    idx = prev_idx.long()
    score = logits.gather(-1, idx)
    penalized = torch.where(score < 0, score * penalty, score / penalty)
    return logits.scatter(-1, idx, penalized)


def top_p_gumbel_sample(gumbel: torch.Tensor, logits: torch.Tensor, temperature, top_p,
                        top_k: int = 0, approx: bool = False) -> torch.Tensor:
    """Nucleus sampling over sorted candidates; returns (B,) int32 ids.  The
    top-p mask is taken on the unscaled logits, the temperature after it.
    ``gumbel`` (B, >= width) lines up with the candidates in rank order.
    ``approx`` runs the exact search (see the module docstring)."""
    del approx  # lax.approx_max_k is exact off the TPU, and so is the port
    logits = logits.float()
    V = logits.shape[-1]
    if 0 < top_k < V:
        z = _logsumexp(logits)  # the full vocabulary's normalizer
        vals, idx = _ranked(logits, top_k)
    else:
        vals, idx = _ranked(logits, V)
        z = _logsumexp(vals)
    probs = torch.exp(vals - z)
    remove = torch.cumsum(probs, dim=-1) > top_p
    remove[..., 0] = False  # keep at least the top candidate
    masked = torch.where(remove, NEG_INF, vals)
    scaled = masked / torch.clamp(torch.as_tensor(temperature), min=1e-5)
    choice = torch.argmax(scaled + gumbel[..., :vals.shape[-1]], dim=-1)
    return idx.gather(-1, choice[:, None])[:, 0].to(torch.int32)


def top_p_threshold_mask(logits: torch.Tensor, top_p, iters: int = BISECT_ITERS
                         ) -> torch.Tensor:
    """Exact nucleus membership without a sort: keep i iff the softmax mass
    at logits >= l_i is within ``top_p`` (an upper level set found by
    ``iters`` bisection steps over [amax - 30, amax + 1]), or i is the
    argmax, or ``top_p >= 1``.  A tie group on the boundary is kept or
    dropped whole."""
    z = _logsumexp(logits)
    p = torch.exp(logits - z)
    amax = logits.max(dim=-1, keepdim=True).values
    lo, hi = amax - 30.0, amax + 1.0
    zero = torch.zeros((), dtype=p.dtype, device=p.device)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        mass = torch.where(logits >= mid, p, zero).sum(dim=-1, keepdim=True)
        take_hi = mass <= top_p
        lo, hi = torch.where(take_hi, lo, mid), torch.where(take_hi, mid, hi)
    keep = (logits >= hi) | (logits >= amax)
    return keep | (torch.as_tensor(top_p, device=logits.device) >= 1.0)


def top_p_threshold_sample(gumbel: torch.Tensor, logits: torch.Tensor, temperature,
                           top_p) -> torch.Tensor:
    """Nucleus sampling with :func:`top_p_threshold_mask`: the Gumbel argmax
    over the whole vocabulary.  Returns (B,) int32."""
    logits = logits.float()
    keep = top_p_threshold_mask(logits, top_p)
    masked = torch.where(keep, logits, NEG_INF)
    scaled = masked / torch.clamp(torch.as_tensor(temperature), min=1e-5)
    return torch.argmax(scaled + gumbel[..., :logits.shape[-1]], dim=-1).to(torch.int32)


def sample(gumbel: torch.Tensor, logits: torch.Tensor, temperature, top_p,
           repetition_penalty, prev_idx: torch.Tensor | None = None, top_k: int = 0,
           approx: bool = False) -> torch.Tensor:
    """One sampling step: the penalty over ``prev_idx`` (B, W) when given,
    then top-p by ``top_k`` (see the module docstring).  ``gumbel`` (B, n)
    holds at least :func:`candidate_width` lanes.  Returns (B,) int32."""
    if prev_idx is not None:
        logits = apply_repetition_penalty(logits.float(), prev_idx, repetition_penalty)
    if top_k == -1:
        return top_p_threshold_sample(gumbel, logits, temperature, top_p)
    return top_p_gumbel_sample(gumbel, logits, temperature, top_p, top_k=top_k, approx=approx)


def logits_to_probs_exact(logits: torch.Tensor, temperature, top_p, repetition_penalty,
                          prev_idx: torch.Tensor | None = None) -> torch.Tensor:
    """The reference's post-top-p softmax distribution of one row (V,), by
    a full sort: for tests."""
    logits = logits.float()
    if prev_idx is not None:
        logits = apply_repetition_penalty(logits[None], prev_idx[None],
                                          repetition_penalty)[0]
    order = torch.sort(-logits, stable=True).indices
    cum = torch.cumsum(torch.softmax(logits[order], dim=-1), dim=-1)
    remove_sorted = cum > top_p
    remove_sorted[0] = False
    remove = torch.zeros_like(remove_sorted).scatter(0, order, remove_sorted)
    logits = torch.where(remove, NEG_INF, logits)
    return torch.softmax(logits / torch.clamp(torch.as_tensor(temperature), min=1e-5), dim=-1)
