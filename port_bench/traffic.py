"""The one traffic generator: a mix file's parameters -> requests.

A mix (``traffic/<name>.json``) names its ``kind`` (how the harness drives
the program: ``serve_closed``, ``serve_open`` or ``stream_closed``, see
``drive.py``) and the parameters this module reads:

- ``prompt_tokens`` [lo, hi]: the text's length in tokens of the byte
  vocabulary (one ASCII byte each);
- ``frames`` [lo, hi]: each request's ``max_new_tokens``;
- ``grid``: how many evenly spaced values of each range one cycle of
  requests takes, each once, in an order drawn from the seed; so every
  seed asks for the same sizes and only their order changes;
- ``greedy_every``: every n-th request decodes greedily (the check's
  sample is drawn from those); the others sample with ``sampling``;
- ``voices`` (optional): ``frames`` and ``text_chars`` of the seeded voice
  references, one per request in turn (in an order drawn from the seed);
- ``rate_per_s`` (``serve_open``): Poisson arrivals, the gaps the
  exponential's quantiles at the grid's midpoints, in seeded order.

Everything is a function of (seed, request index): the same seed gives the
same requests, whatever the program does.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

GREEDY = {"temperature": 1e-5, "top_p": 0.8, "repetition_penalty": 1.0}
WORDS = ("the quiet harbour light fell across old stones while the tide came in and "
         "a small boat turned toward home under a long grey evening sky full of birds "
         "that called over water and wind as the town began to settle for night").split()


@dataclass
class Request:
    index: int
    text: str
    frames: int
    sampling: dict
    greedy: bool
    voice: int | None
    seed: int | None  # the request's own sampling seed


def text_of(rng: np.random.Generator, n: int) -> str:
    """ASCII words, cut to exactly ``n`` bytes."""
    out = ""
    while len(out) < n:
        out += WORDS[int(rng.integers(len(WORDS)))] + " "
    return out[:n - 1] + "."


class Traffic:
    """The requests of mix ``spec`` under ``seed``; ``codebooks`` is (K,
    semantic codebook size, residual codebook size) for the voices."""

    def __init__(self, spec: dict, seed: int, codebooks: tuple[int, int, int]):
        self.spec, self.seed = spec, int(seed)
        self.grid = int(spec.get("grid", 64))
        K, n_sem, n_res = codebooks
        self.voices: list[tuple[str, np.ndarray]] = []
        v = spec.get("voices")
        if v:
            lo, hi = v["text_chars"]
            for i, n in enumerate(v["frames"]):
                rng = self._rng(1, i)
                codes = np.concatenate([rng.integers(0, n_sem, (1, n)),
                                        rng.integers(0, n_res, (K - 1, n))]).astype(np.int64)
                self.voices.append((text_of(rng, int(rng.integers(lo, hi + 1))), codes))

    def _rng(self, stream: int, i: int) -> np.random.Generator:
        return np.random.default_rng([self.seed & 0xFFFFFFFF, self.seed >> 32, stream, i])

    def _pick(self, stream: int, i: int, values: np.ndarray):
        """Value ``i`` of cycles that each take every one of ``values``
        once, in an order drawn per cycle."""
        cycle, j = divmod(i, len(values))
        return values[self._rng(stream, cycle).permutation(len(values))[j]]

    def _range(self, lo: int, hi: int) -> np.ndarray:
        return np.round(np.linspace(lo, hi, self.grid)).astype(int)

    def request(self, i: int) -> Request:
        s = self.spec
        n_text = int(self._pick(2, i, self._range(*s["prompt_tokens"])))
        frames = int(self._pick(3, i, self._range(*s["frames"])))
        voice = None
        if self.voices:
            voice = int(self._pick(4, i, np.arange(len(self.voices))))
        greedy = i % int(s.get("greedy_every", 0) or 1 << 62) == 0
        return Request(index=i, text=text_of(self._rng(5, i), n_text), frames=frames,
                       sampling=dict(GREEDY if greedy else s["sampling"]), greedy=greedy,
                       voice=voice, seed=int(self._rng(7, i).integers(1 << 31)))

    def gaps(self) -> np.ndarray:
        """Inter-arrival gaps of one cycle, in seconds, sorted."""
        u = (np.arange(self.grid) + 0.5) / self.grid
        return -np.log1p(-u) / float(self.spec["rate_per_s"])

    def arrival(self, i: int) -> float:
        """Seconds from the window's start to request ``i``'s arrival."""
        gaps = self.gaps()
        cycle, j = divmod(i, self.grid)
        full = cycle * gaps.sum()
        order = self._rng(6, cycle).permutation(self.grid)
        return float(full + gaps[order[:j + 1]].sum())

    def voice_refs(self, req: Request) -> list[tuple[str, np.ndarray]]:
        return [] if req.voice is None else [self.voices[req.voice]]
