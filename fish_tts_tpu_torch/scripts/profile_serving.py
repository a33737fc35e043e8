"""Per-phase attribution of the audio-serving round, read from the program's spans.

The port's counterpart of ``scripts/profile_serving.py``: it runs the same
workload (``--slots 16 --budget 200 --requests 32``: the pool filled with
"a serving benchmark request", each finished request replaced until
``--requests`` have been submitted, after two "warm up the pool" requests
of 24 frames) through ``FishTTS.serve`` and reads the spans the program
records itself (``utils/profiling.py``); nothing of the program is wrapped
or replaced.  Its rows, over the measured part:

- each ``serve.*`` span's and the ``vocoder`` span's seconds and count, the
  differences of the engine registry's aggregates: ``serve.round`` (a
  whole round), ``serve.admit`` (an admission's launches),
  ``serve.lm.launch`` (the chunk's launches), ``serve.lm.wait`` (the read
  of a chunk or a first frame), ``serve.codec.launch`` (the pool codec's
  launch), ``vocoder`` (the read of the previous round's PCM),
  ``serve.prepare`` (a request's tokenize and prompt, at submission) and
  ``serve.queue`` (a request's wait in the queue, across rounds);
- the round's self time: ``serve.round`` less the call spans directly
  inside it (``profiling.spans``).

Host clock only: a launch span is the host's enqueue, which blocks when the
launch queue is full; ``--sync`` waits for the device before each round, so
that a launch's time is its own work (the round then loses its overlap of
host and device).  Where the card idles, and what the host was doing then,
is the benchmark's idle split (``port_bench``'s ``idle_in_launch_pct``,
``idle_in_program_pct``, ``idle_outside_pct``, read from a traced run).

Weights: seeded random S1-mini widths run as ``FishTTS(precision="int8")``,
as the JAX script quantizes its LM; ``--tiny`` runs the tiny config in fp32.

Usage: python -m fish_tts_tpu_torch.scripts.profile_serving [--slots 16] [--budget 200]
       [--requests 32] [--sync] [--tiny] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

from fish_tts_tpu_torch.scripts._timing import clock_name, device_line, resolve_device
from fish_tts_tpu_torch.utils import profiling

REQUEST = "a serving benchmark request"
ROUND = "serve.round"
# the rows read from the registry, in the order the table prints them
PHASES = (ROUND, "serve.admit", "serve.lm.launch", "serve.lm.wait", "serve.codec.launch",
          "vocoder", "serve.prepare", "serve.queue")
SELF = "round self time"


def build(args, dev: torch.device):
    from fish_tts_tpu_torch import FishTTS
    from fish_tts_tpu_torch.testing import make_s1_mini_bundle, make_tiny_bundle

    if args.tiny:
        return FishTTS(device=dev.type, precision="fp32", warmup=False,
                       _testing_bundle=make_tiny_bundle(0))
    return FishTTS(device=dev.type, precision="int8", warmup=False,
                   _testing_bundle=make_s1_mini_bundle(0, device=dev))


def _totals(metrics) -> dict[str, tuple[float, int]]:
    return {name: (metrics.phases[name].total_s, metrics.phases[name].count)
            for name in PHASES if name in metrics.phases}


def self_time(records, t0: float, t1: float) -> float:
    """The ``serve.round`` spans inside [t0, t1], less the call spans
    directly inside them."""
    rounds = {r.seq: r for r in records if r.name == ROUND and t0 <= r.start and r.end <= t1}
    children = sum(r.end - r.start for r in records
                   if r.parent in rounds and r.kind != "request")
    return sum(r.end - r.start for r in rounds.values()) - children


def main(argv: list[str] | None = None) -> list[dict]:
    """Print the round's attribution and return it as records: one per
    phase {"label", "host_s", "host_ms_per_round", "share_of_round", "n",
    "derived"} (``derived`` for the self time), then {"label":
    "aggregate", "frames_per_s", "rounds", "ms_per_round", "realtime",
    "frames", "t0", "t1"} (``t0``/``t1``: the measured part on
    ``profiling.now``); each with "device" and "clock"."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--slots", type=int, default=16)
    ap.add_argument("--budget", type=int, default=200, help="max_new_tokens per request")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--sync", action="store_true",
                    help="wait for the device before each round (launch time without waits)")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = device_line(dev)

    t0 = time.perf_counter()
    tts = build(args, dev)
    print(f"# init {time.perf_counter() - t0:.1f}s  device={card}", flush=True)
    sess = tts.serve(slots=args.slots, warmup=False)
    # ---- warmup (graph captures, the codec's first round) -----------------
    t0 = time.perf_counter()
    for _ in range(2):
        sess.submit("warm up the pool", max_new_tokens=24)
    for _ in sess.run():
        pass
    print(f"# warmup {time.perf_counter() - t0:.1f}s", flush=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    # ---- measured workload (the JAX script's) -----------------------------
    before = _totals(tts.metrics)
    pending = args.requests
    frames = pcm_bytes = rounds = 0
    t0 = profiling.now()
    for _ in range(min(args.slots, pending)):
        sess.submit(REQUEST, max_new_tokens=args.budget)
        pending -= 1
    while sess.busy or pending:
        if args.sync and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        evs = sess.step()
        rounds += 1
        for ev in evs:
            pcm_bytes += len(ev.pcm)
            if ev.done:
                frames += ev.frames_total
                if pending:
                    sess.submit(REQUEST, max_new_tokens=args.budget)
                    pending -= 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t1 = profiling.now()
    wall = t1 - t0
    after = _totals(tts.metrics)

    agg = frames / wall
    realtime = pcm_bytes / 2 / tts.sample_rate / wall
    print(f"\n# {agg:.0f} tok/s aggregate, {rounds} rounds, {wall / rounds * 1e3:.1f} ms/round, "
          f"{realtime:.1f}x realtime  (device={card}{', synchronized' * args.sync})", flush=True)
    delta = {name: (s - before.get(name, (0.0, 0))[0], n - before.get(name, (0.0, 0))[1])
             for name, (s, n) in after.items()}
    tot = delta.get(ROUND, (0.0, 0))[0]
    clock = clock_name(dev)
    records = []

    def row(label: str, host: float, n: int | None, derived=False):
        share = host / tot if tot else 0.0
        records.append({"label": label, "host_s": host, "host_ms_per_round": host / rounds * 1e3,
                        "share_of_round": share, "n": n, "derived": derived, "device": card,
                        "clock": clock})
        calls = "" if n is None else f"; n={n}"
        print(f"  {label:22s} {host:8.3f} s  ({host / rounds * 1e3:7.2f} host ms/round, "
              f"{100 * share:5.1f}% of the rounds{calls})", flush=True)

    for name in PHASES:
        host, n = delta.get(name, (0.0, 0))
        row(name, host, n)
    row(SELF, self_time(profiling.spans(t0, t1), t0, t1), None, derived=True)
    records.append({"label": "aggregate", "frames_per_s": agg, "rounds": rounds,
                    "ms_per_round": wall / rounds * 1e3, "realtime": realtime,
                    "frames": frames, "t0": t0, "t1": t1, "device": card, "clock": clock})
    return records


if __name__ == "__main__":
    main()
