"""Bit-exactness check of the slow-token sampler kernel against the plain
route's threshold sampler at the full S1-mini vocabulary.

The port's counterpart of ``scripts/verify_sampler_tpu.py`` (the ``_tpu`` in
that name named the JAX target).  For B in {1, 8, 16}, seeds 0-2 and
(temperature, top_p, penalty) in {(0.7, 0.8, 1.1), (0.9, 1.0, 1.0)}: logits
N(0, 1) * 4 of shape (B, V) f32 with V = ``cfg.vocab_size`` = 155 776 (the
JAX docstring's 155 767 is not the width its script runs), a penalty window
of 11 ids in [0, V), and one Gumbel tensor (B, V) that both sides take, so
their lanes line up (``Route.draws`` gives both routes V lanes).  It holds
``ops/sampler_kernel.sample_slow`` against ``engine/sampling.sample(...,
top_k=-1)``.  The port's kernel has no ``vocab=`` argument for padded
lanes: the port's head emits exactly V columns.

A differing token is excused only at a knife edge of the plain sampler's own
numbers (``testing.slow_decision_margins``: a bisection mass within 1e-6 of
top_p, or the two largest perturbed values within 1e-6), and counted.  On
the card the kernel launches; with ``--device cpu`` both sides are plain.

Prints one OK/MISMATCH line per (B, seed, params) and a total; ``main``
returns the exit code, 1 on any mismatch that is not at a knife edge.

Usage: python -m fish_tts_tpu_torch.scripts.verify_sampler [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import torch

from fish_tts_tpu_torch.config import S1_MINI_CONFIG
from fish_tts_tpu_torch.engine import sampling
from fish_tts_tpu_torch.engine.decode import gumbel_from_uniform
from fish_tts_tpu_torch.ops import sampler_kernel
from fish_tts_tpu_torch.scripts._timing import device_line, resolve_device
from fish_tts_tpu_torch.testing import slow_decision_margins

WINDOW = 11
BATCHES = (1, 8, 16)
SEEDS = 3
SETTINGS = ((0.7, 0.8, 1.1), (0.9, 1.0, 1.0))  # temperature, top_p, repetition penalty


def inputs(B: int, seed: int, V: int, dev: torch.device):
    """(logits, prev, gumbel) of one case, drawn from ``seed`` on ``dev``."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    logits = torch.randn((B, V), generator=gen, device=dev) * 4.0
    prev = torch.randint(0, V, (B, WINDOW), generator=gen, device=dev, dtype=torch.int32)
    gumbel = gumbel_from_uniform(torch.rand((B, V), generator=gen, device=dev))
    return logits, prev, gumbel


def main(argv: list[str] | None = None) -> int:
    """Print the per-case lines and the total; return the exit code."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    V = S1_MINI_CONFIG.vocab_size
    print(f"vocab: {V} device: {device_line(dev)}", flush=True)

    mismatch = knife = 0
    for B in BATCHES:
        for seed in range(SEEDS):
            logits, prev, gumbel = inputs(B, seed, V, dev)
            for t, p, r in SETTINGS:
                cols = [torch.full((B, 1), v, dtype=torch.float32, device=dev)
                        for v in (t, p, r)]
                got = sampler_kernel.sample_slow(logits, prev, gumbel, *cols)
                want = sampling.sample(gumbel, logits, *cols, prev_idx=prev, top_k=-1)
                edges = bad = 0
                if not torch.equal(got, want):
                    m = slow_decision_margins(got, want, logits, prev, gumbel, *cols)
                    edges, bad = m["knife_edges"], len(m["failures"])
                    for msg in m["failures"]:
                        print(f"  {msg}", flush=True)
                mismatch += bad
                knife += edges
                status = "OK" if bad == 0 else f"{bad} MISMATCH"
                if edges:
                    status += f" ({edges} at a knife edge)"
                print(f"B={B} seed={seed} t={t} p={p}: {status}", flush=True)
    print(f"total mismatches: {mismatch} (knife edges excused: {knife})", flush=True)
    return 1 if mismatch else 0


if __name__ == "__main__":
    raise SystemExit(main())
