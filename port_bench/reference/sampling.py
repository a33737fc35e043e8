"""The sampler's rules, plain, for judging sampled (not greedy) tokens.

OpenAudio S1-mini samples each token as the reference implementation does:
the repetition penalty over a window of earlier frames (a positive logit
divided by the penalty, a negative one multiplied, each id once), then the
nucleus (top-p) on the penalised, unscaled logits (a token is kept when
the softmax mass at logits at least its own is within ``top_p``; the best
is always kept), then the Gumbel-max draw over the kept tokens at the
temperature: ``argmax(logit / T + g)``.

The Gumbel noise ``g`` is counter-based, so it is a function of the
request's seed, the decode step and the lane, and the harness works it out
again from the seed it gave the request:

- the request's generation seed ``s = default_rng(seed).integers(0, 2**63 - 1)``;
- its key ``mix32(mix32(mix32(0) ^ lo(s)) ^ hi(s))``;
- lane i at step t: the word ``mix32(mix32(i) ^ mix32(key ^ t))``,
  ``u = (word + 1/2) / 2**32``, ``g = -log(-log(u))`` in float64, rounded to
  float32.  The slow token reads lanes ``[0, V)``, residual book b
  (1-based) lanes ``V + (b - 1) Vr`` on; the prompt's frame draws at step
  ``PREFILL_STEP``, decode frame f >= 1 at step f - 1.

The penalty window (``WINDOW`` frames) holds the decode frames before the
current one, not the prompt's frame, zeros where nothing was written yet;
the slow token is penalised by one whole frame's ids (the first decode
frame while fewer than ``WINDOW`` were written, else the oldest), each
residual book by its own codes in the window.  The prompt's frame has no
penalty.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
MUL = (0x7FEB352D, 0x6C8E9CF5)
PREFILL_STEP = 0x7FFFFFFF
WINDOW = 16


def mix32(x):
    """A bijective 32-bit mixer on an int or an int64 tensor of 32-bit words."""
    x = x ^ (x >> 16)
    x = (x * MUL[0]) & M32
    x = x ^ (x >> 15)
    x = (x * MUL[1]) & M32
    return x ^ (x >> 16)


def request_key(seed: int) -> int:
    """The noise key of a request submitted with ``seed``."""
    s = int(np.random.default_rng(seed).integers(0, 2**63 - 1))
    return mix32(mix32(mix32(0) ^ (s & M32)) ^ ((s >> 32) & M32))


def gumbel(key: int, steps: torch.Tensor, lo: int, n: int) -> torch.Tensor:
    """(len(steps), n) float32 draws of lanes [lo, lo + n) at ``steps``."""
    dev = steps.device
    k = mix32(torch.as_tensor(key, dtype=torch.int64, device=dev) ^ steps.long())
    lanes = mix32(torch.arange(lo, lo + n, dtype=torch.int64, device=dev))
    x = mix32(lanes[None] ^ k[:, None])
    return x.double().add_(0.5).mul_(2.0 ** -32).log_().neg_().log_().neg_().float()


def steps_of(first: int, n: int, device) -> torch.Tensor:
    """The noise steps of served frames ``first .. first + n - 1``."""
    f = torch.arange(first, first + n, device=device)
    return torch.where(f == 0, torch.full_like(f, PREFILL_STEP), f - 1)


def penalties(first: int, n: int, penalty: float, device) -> torch.Tensor:
    """(n, 1) the penalty of served frames ``first ..``: none on the prompt's."""
    f = torch.arange(first, first + n, device=device)[:, None]
    return torch.where(f == 0, 1.0, float(penalty)).float()


def penalise(logits: torch.Tensor, ids: torch.Tensor, penalty: torch.Tensor) -> torch.Tensor:
    """logits (n, V); ids (n, W) the ids each row penalises; penalty (n, 1)."""
    hit = torch.zeros_like(logits, dtype=torch.bool).scatter_(1, ids.long(), True)
    pen = torch.where(logits < 0, logits * penalty, logits / penalty)
    return torch.where(hit, pen, logits)


def slow_penalty_ids(frames: torch.Tensor, first: int, n: int) -> torch.Tensor:
    """frames (F, 1+K) served [token, codes]: the ids that penalise the slow
    token of frames ``first .. first + n - 1``, (n, 1+K)."""
    rows = []
    for f in range(first, first + n):
        s = f - 1  # the decode step
        if s <= 0:
            rows.append(torch.zeros_like(frames[0]))
        else:
            rows.append(frames[1 if s < WINDOW else s - WINDOW + 1])
    return torch.stack(rows)


def book_penalty_ids(frames: torch.Tensor, book: int, first: int, n: int) -> torch.Tensor:
    """The ids that penalise residual book ``book`` (1-based) of frames
    ``first .. first + n - 1``: its codes in the window, zeros for unwritten
    slots, (n, WINDOW)."""
    col = frames[:, 1 + book]
    rows = []
    for f in range(first, first + n):
        got = col[max(1, f - WINDOW):f] if f >= 1 else col[:0]
        rows.append(torch.cat([got, torch.zeros(WINDOW - got.numel(), dtype=col.dtype,
                                                device=col.device)]))
    return torch.stack(rows)


# A token whose nucleus mass lies within this of ``top_p`` may be kept or not.
# A residual book's 1,024 codes are near-flat, some 0.5 of mass per logit unit
# at the edge, and bf16 rounding of the fast stack moves the mass at a token by
# up to about 0.02 (0.0205 seen once on H100, bf16 route); twice that is kept.
EDGE = 0.04


def nucleus_floors(logits: torch.Tensor, *tops: float) -> list[torch.Tensor]:
    """For each top-p in ``tops``, the lowest logit of each row's nucleus
    (rows of (n, V) penalised logits)."""
    vals = torch.sort(logits, dim=-1, descending=True).values
    mass = torch.cumsum(torch.softmax(vals, dim=-1), dim=-1)
    out = []
    for p in tops:
        keep = mass <= p
        keep[:, 0] = True
        out.append(torch.where(keep, vals, torch.full_like(vals, float("inf"))).min(dim=-1).values)
    return out


def pick(logits: torch.Tensor, noise: torch.Tensor, temperature: float, top_p: float
         ) -> torch.Tensor:
    """The token the rules draw from (n, V) penalised logits and their noise."""
    floor, = nucleus_floors(logits, top_p)
    score = torch.where(logits >= floor[:, None], logits / temperature + noise,
                        torch.full_like(logits, float("-inf")))
    return score.argmax(dim=-1)


def gap(logits: torch.Tensor, noise: torch.Tensor, temperature: float, top_p: float,
        tok: torch.Tensor) -> torch.Tensor:
    """By how much, in logit units, each chosen ``tok`` falls short of the
    rules' own draw: the larger of how far its score lies below the best
    score inside the nucleus (times the temperature) and how far its logit
    lies below the nucleus, and 0.  The nucleus's edge, the tokens whose
    mass lies within ``EDGE`` of ``top_p``, counts as outside for the best
    score and inside for the chosen token: rounding puts them on either
    side (the program's logits differ from the reference's by a few
    hundredths, and the mass at a token's logit with them)."""
    inner, outer = nucleus_floors(logits, top_p - EDGE, top_p + EDGE)
    score = logits + temperature * noise
    best = torch.where(logits >= inner[:, None], score,
                       torch.full_like(score, float("-inf"))).max(dim=-1).values
    mine = score.gather(1, tok[:, None].long())[:, 0]
    below = outer - logits.gather(1, tok[:, None].long())[:, 0]
    return torch.clamp(torch.maximum(best - mine, below), min=0.0)
