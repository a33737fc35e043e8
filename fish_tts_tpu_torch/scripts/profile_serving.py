"""Per-phase attribution of the audio-serving round, in host and device time.

The port's counterpart of ``scripts/profile_serving.py``: it runs the same
workload (``--slots 16 --budget 200 --requests 32``: the pool filled with
"a serving benchmark request", each finished request replaced until
``--requests`` have been submitted, after two "warm up the pool" requests
of 24 frames) through ``FishTTS.serve`` with the round's pieces wrapped,
each under the JAX script's label:

- ``ServeSession._emit``: "audio_fetch+convert" (the previous round's PCM
  read back and cut into events);
- ``ContinuousBatcher.step``: "lm_step" (admission, the chunk's dispatch
  and the previous chunk's read-back);
- the pool codec function ``ServeSession._decode``: "voc_dispatch";
- ``DecodeGraph.run`` (the eager ``decode.decode_chunk`` on the CPU):
  "lm_dispatch", the port's LM dispatch;
- ``ContinuousBatcher._process``: "lm_frames_fetch+route".

Two clocks.  The host's clock around a piece gives its host time, which on
the card is mostly enqueue.  So each piece also records CUDA events on the
current stream (the pool's) around itself; their spans, read after one
final synchronize, are the time the stream took from the piece's start to
its end, idle gaps included.  Both are printed per round; on the CPU there
is no device column.  A host time may include a wait for earlier work (a
full launch queue blocks the host); ``--sync`` waits for the stream before
each piece, so that its host time is its own work (the round then loses its
overlap of host and device).  Every wrapped attribute is restored in a
``finally``.

Weights: seeded random S1-mini widths run as ``FishTTS(precision="int8")``,
as the JAX script quantizes its LM; ``--tiny`` runs the tiny config in fp32.

Usage: python -m fish_tts_tpu_torch.scripts.profile_serving [--slots 16] [--budget 200]
       [--requests 32] [--sync] [--tiny] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import time
from collections import defaultdict

import torch

from fish_tts_tpu_torch.engine import decode as decode_mod
from fish_tts_tpu_torch.engine import serve as serve_mod
from fish_tts_tpu_torch.scripts._timing import clock_name, device_line, resolve_device

REQUEST = "a serving benchmark request"
# the wrapped pieces and their labels, in the order the table prints them
LM_STEP, LM_DISPATCH, LM_FETCH = "lm_step", "lm_dispatch", "lm_frames_fetch+route"
AUDIO, VOC = "audio_fetch+convert", "voc_dispatch"
TOTAL = "TOTAL step"


class Phases:
    """Host seconds, calls and CUDA event pairs per label."""

    def __init__(self, dev: torch.device, sync: bool = False):
        self.cuda = dev.type == "cuda"
        self.sync = sync and self.cuda
        self.host: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.events: dict[str, list] = defaultdict(list)

    def clear(self) -> None:
        for d in (self.host, self.counts, self.events):
            d.clear()

    @contextlib.contextmanager
    def span(self, label: str):
        ev = None
        if self.sync:
            torch.cuda.current_stream().synchronize()
        if self.cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        t = time.perf_counter()
        try:
            yield
        finally:
            self.host[label] += time.perf_counter() - t
            self.counts[label] += 1
            if ev is not None:
                ev[1].record()
                self.events[label].append(ev)

    def wrap(self, fn, label: str):
        def timed(*a, **kw):
            with self.span(label):
                return fn(*a, **kw)
        return timed

    def device_s(self, label: str) -> float | None:
        """The label's summed event spans (call after a synchronize)."""
        if not self.cuda:
            return None
        return sum(a.elapsed_time(b) for a, b in self.events.get(label, ())) / 1e3


@contextlib.contextmanager
def instrument(sess, phases: Phases):
    """Wrap the serving round's pieces (see the module docstring) for the
    duration of the block; every attribute is restored on the way out."""
    cls_attrs = [(decode_mod.DecodeGraph, "run", LM_DISPATCH),
                 (decode_mod, "decode_chunk", LM_DISPATCH),
                 (serve_mod.ContinuousBatcher, "_process", LM_FETCH)]
    inst_attrs = [(sess, "_emit", AUDIO), (sess._srv, "step", LM_STEP), (sess, "_decode", VOC)]
    saved = [(obj, name, obj.__dict__.get(name, _MISSING)) for obj, name, _ in
             cls_attrs + inst_attrs]
    try:
        for obj, name, label in cls_attrs + inst_attrs:
            setattr(obj, name, phases.wrap(getattr(obj, name), label))
        yield
    finally:
        for obj, name, old in saved:
            if old is _MISSING:
                delattr(obj, name)
            else:
                setattr(obj, name, old)


_MISSING = object()


def build(args, dev: torch.device):
    from fish_tts_tpu_torch import FishTTS
    from fish_tts_tpu_torch.testing import make_s1_mini_bundle, make_tiny_bundle

    if args.tiny:
        return FishTTS(device=dev.type, precision="fp32", warmup=False,
                       _testing_bundle=make_tiny_bundle(0))
    return FishTTS(device=dev.type, precision="int8", warmup=False,
                   _testing_bundle=make_s1_mini_bundle(0, device=dev))


def main(argv: list[str] | None = None) -> list[dict]:
    """Print the round's attribution and return it as records: one per
    phase {"label", "host_s", "host_ms_per_round", "device_ms_per_round"
    (None on the CPU), "share_of_step", "n", "derived"} (``derived`` for the
    remainders computed from the others), then {"label": "aggregate",
    "frames_per_s", "rounds", "ms_per_round", "realtime", "frames"}; each
    with "device" and "clock"."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--slots", type=int, default=16)
    ap.add_argument("--budget", type=int, default=200, help="max_new_tokens per request")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--sync", action="store_true",
                    help="wait for the stream before each piece (host time without waits)")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = device_line(dev)

    t0 = time.perf_counter()
    tts = build(args, dev)
    print(f"# init {time.perf_counter() - t0:.1f}s  device={card}", flush=True)
    sess = tts.serve(slots=args.slots, warmup=False)
    phases = Phases(dev, sync=args.sync)
    with instrument(sess, phases):
        # ---- warmup (graph captures, the codec's first round) -------------
        t0 = time.perf_counter()
        for _ in range(2):
            sess.submit("warm up the pool", max_new_tokens=24)
        for _ in sess.run():
            pass
        print(f"# warmup {time.perf_counter() - t0:.1f}s", flush=True)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        phases.clear()

        # ---- measured workload (the JAX script's) -------------------------
        pending = args.requests
        frames = pcm_bytes = rounds = 0
        t0 = time.perf_counter()
        for _ in range(min(args.slots, pending)):
            sess.submit(REQUEST, max_new_tokens=args.budget)
            pending -= 1
        while sess.busy or pending:
            with phases.span(TOTAL):
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
        wall = time.perf_counter() - t0

    agg = frames / wall
    realtime = pcm_bytes / 2 / tts.sample_rate / wall
    print(f"\n# {agg:.0f} tok/s aggregate, {rounds} rounds, {wall / rounds * 1e3:.1f} ms/round, "
          f"{realtime:.1f}x realtime  (device={card}{', synchronized' * args.sync})", flush=True)
    tot = phases.host[TOTAL]
    clock = clock_name(dev)
    records = []

    def row(label: str, host: float, device: float | None, n: int | None, derived=False):
        dev_ms = None if device is None else device / rounds * 1e3
        records.append({"label": label, "host_s": host, "host_ms_per_round": host / rounds * 1e3,
                        "device_ms_per_round": dev_ms, "share_of_step": host / tot,
                        "n": n, "derived": derived, "device": card, "clock": clock})
        dev_col = "not measured" if dev_ms is None else f"{dev_ms:8.2f} device ms/round"
        calls = "" if n is None else f"; n={n}"
        print(f"  {label:28s} {host:8.2f} s  ({host / rounds * 1e3:7.2f} host ms/round, "
              f"{dev_col}, {100 * host / tot:5.1f}% of step{calls})", flush=True)

    def measured(label: str, shown: str | None = None):
        row(shown or label, phases.host[label], phases.device_s(label), phases.counts[label])

    measured(LM_STEP, "lm_step (total)")
    measured(LM_DISPATCH, "  lm_dispatch")
    measured(LM_FETCH, "  lm_frames_fetch+route")
    lm = phases.host[LM_STEP]
    row("  lm sched remainder", lm - phases.host[LM_DISPATCH] - phases.host[LM_FETCH], None,
        None, derived=True)
    top = lm
    for label in sorted((AUDIO, VOC), key=lambda k: -phases.host[k]):
        measured(label)
        top += phases.host[label]
    row("host_other (rest of step)", tot - top, None, None, derived=True)
    measured(TOTAL)
    records.append({"label": "aggregate", "frames_per_s": agg, "rounds": rounds,
                    "ms_per_round": wall / rounds * 1e3, "realtime": realtime,
                    "frames": frames, "device": card, "clock": clock})
    return records


if __name__ == "__main__":
    main()
