"""End-to-end benchmark of the port: RTF over three utterances, streaming
time to first audio, batched synthesis and the engine's spans.

The port's counterpart of ``scripts/benchmark.py``: the same ``WORKLOADS``,
the same ``Report`` and its JSON keys, the same sequence of calls (a warm
``synthesize("Test", max_tokens=32)``, ``metrics.reset()``, one timed
``synthesize`` per workload, ``get_metrics()``, ``synthesize_stream`` of the
long utterance timed to its first chunk, a warm ``synthesize_batch`` of the
three texts at 8 tokens, then the timed batch).  The port adds:

- ``--device cuda|cpu`` (``cuda`` by default; without a card it raises);
- ``--random-s1 --seed N``: seeded random S1-mini-width weights
  (``testing.make_s1_mini_bundle``) in place of a checkpoint, since the port
  downloads nothing;
- ``--max-tokens``: 64 with ``--tiny``, else 2048.  Random weights never
  sample ``<|im_end|>``, so every call runs its whole budget;
- ``device`` (the card's name and power limit) and ``peak_memory_gb`` (the
  peak device memory allocated over the run, None on the CPU) in the JSON,
  and ``frames`` (the frames each call's WAV holds, from the engine's token
  count: the final frame is stripped, as in the reference) in each row.

Wall times are the host's clock around calls that return host bytes (the
device is waited for); on the CPU they are CPU times.

Usage: python -m fish_tts_tpu_torch.scripts.benchmark [--model-dir DIR | --random-s1 |
       --tiny] [--precision P] [--max-tokens N] [--json] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import time
from dataclasses import dataclass, field

import torch

from fish_tts_tpu_torch.scripts._timing import device_line, resolve_device

SAMPLE_RATE = 44100
WAV_HEADER_BYTES = 44

# The reference benchmark's utterances, so RTF numbers stay comparable.
WORKLOADS = (
    ("short", "Hello world!"),
    ("medium", "The quick brown fox jumps over the lazy dog."),
    ("long",
     "In a world where technology advances rapidly, artificial intelligence "
     "has emerged as a transformative force reshaping how we live and work."),
)


@dataclass
class Report:
    """Accumulates benchmark rows; renders a table or JSON."""

    init_s: float = 0.0
    rows: list[dict] = field(default_factory=list)
    streaming: dict = field(default_factory=dict)
    batch: dict = field(default_factory=dict)
    components: dict = field(default_factory=dict)
    device: str = "cpu"
    peak_memory_gb: float | None = None

    def add_row(self, **kw) -> None:
        self.rows.append(kw)

    @property
    def mean_rtf(self) -> float:
        audio = sum(r["audio_s"] for r in self.rows)
        wall = sum(r["wall_s"] for r in self.rows)
        return wall / audio if audio else 0.0

    def render(self) -> str:
        lines = [
            f"# device={self.device}",
            f"init: {self.init_s:.1f}s",
            "",
            f"{'workload':<10}{'chars':>6}{'audio_s':>9}{'wall_s':>8}{'rtf':>7}",
        ]
        for r in self.rows:
            lines.append(
                f"{r['name']:<10}{r['chars']:>6}{r['audio_s']:>9.2f}"
                f"{r['wall_s']:>8.2f}{r['rtf']:>7.3f}"
            )
        lines.append(f"{'mean':<10}{'':>6}{'':>9}{'':>8}{self.mean_rtf:>7.3f}")
        if self.streaming:
            s = self.streaming
            lines += [
                "",
                f"streaming: first chunk {s['ttfa_s']:.3f}s, "
                f"{s['audio_s']:.2f}s audio in {s['wall_s']:.2f}s "
                f"(rtf {s['rtf']:.3f}, {s['chunks']} chunks)",
            ]
        if self.batch:
            b = self.batch
            lines += [
                "",
                f"batched serving: {b['streams']} streams, "
                f"{b['audio_s']:.2f}s total audio in {b['wall_s']:.2f}s "
                f"(aggregate rtf {b['rtf']:.3f}, "
                f"{b['audio_per_wall']:.1f}x realtime aggregate)",
            ]
        if self.components:
            lines.append("")
            lines.append("engine spans (from FishTTS.get_metrics()):")
            for name, ph in self.components.get("phases", {}).items():
                lines.append(
                    f"  {name:<9} {ph['count']:>4}x  mean {ph['mean_ms']:>8.2f} ms"
                    f"  total {ph['total_s']:>7.2f} s"
                )
            lines.append(
                f"  engine throughput: "
                f"{self.components.get('tokens_per_sec', 0):.1f} tok/s"
            )
        if self.peak_memory_gb is not None:
            lines.append(f"peak device memory: {self.peak_memory_gb:.2f} GB")
        return "\n".join(lines)

    def as_dict(self) -> dict:
        return {
            "init_s": round(self.init_s, 2),
            "mean_rtf": round(self.mean_rtf, 4),
            "rows": self.rows,
            "streaming": self.streaming,
            "batch": self.batch,
            "components": self.components,
            "device": self.device,
            "peak_memory_gb": self.peak_memory_gb,
        }

    def as_json(self) -> str:
        return json.dumps(self.as_dict())


def wav_seconds(wav: bytes) -> float:
    return (len(wav) - WAV_HEADER_BYTES) / (SAMPLE_RATE * 2)


def build_synth(args, dev: torch.device):
    from fish_tts_tpu_torch import FishTTS
    from fish_tts_tpu_torch.testing import make_s1_mini_bundle, make_tiny_bundle

    if args.tiny:
        return FishTTS(device=dev.type, precision="fp32", warmup=True,
                       _testing_bundle=make_tiny_bundle(args.seed))
    if args.random_s1:
        return FishTTS(device=dev.type, precision=args.precision, warmup=True,
                       _testing_bundle=make_s1_mini_bundle(args.seed, device=dev))
    return FishTTS(model_dir=args.model_dir, device=dev.type, precision=args.precision)


def run(args, dev: torch.device) -> Report:
    rep = Report(device=device_line(dev))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    synth = build_synth(args, dev)
    rep.init_s = time.perf_counter() - t0

    synth.synthesize("Test", max_tokens=32)  # make sure the graphs and kernels are warm
    synth.metrics.reset()

    max_tokens = args.max_tokens or (64 if args.tiny else 2048)
    for name, text in WORKLOADS:
        if args.tiny:
            # the tiny config's context (128) can't fit the long utterances
            text = text[:40]
        tokens = synth.metrics.tokens_generated
        t0 = time.perf_counter()
        wav = synth.synthesize(text, max_tokens=max_tokens)
        wall = time.perf_counter() - t0
        audio = wav_seconds(wav)
        # the WAV holds every generated frame but the stripped final one
        frames = synth.metrics.tokens_generated - tokens - 1
        rep.add_row(
            name=name, chars=len(text), frames=frames, audio_s=round(audio, 3),
            wall_s=round(wall, 3),
            rtf=round(wall / audio, 4) if audio else 0.0,
        )

    # component breakdown accumulated by the engine across the runs above
    rep.components = synth.get_metrics()

    # streaming: time-to-first-chunk + sustained RTF on the long utterance
    text = WORKLOADS[-1][1][:40] if args.tiny else WORKLOADS[-1][1]
    ttfa = None
    n_bytes = 0
    n_chunks = 0
    t0 = time.perf_counter()
    for chunk in synth.synthesize_stream(text, max_tokens=max_tokens):
        if ttfa is None:
            ttfa = time.perf_counter() - t0
        n_bytes += len(chunk)
        n_chunks += 1
    wall = time.perf_counter() - t0
    audio = n_bytes / (SAMPLE_RATE * 2)
    rep.streaming = {
        "ttfa_s": round(ttfa or 0.0, 4),
        "audio_s": round(audio, 3),
        "wall_s": round(wall, 3),
        "rtf": round(wall / audio, 4) if audio else 0.0,
        "chunks": n_chunks,
    }

    # batched synthesis: all workloads decode together, one model pass per frame
    texts = [t[:40] if args.tiny else t for _, t in WORKLOADS]
    synth.synthesize_batch(texts, max_tokens=8)  # warm the batched graphs
    t0 = time.perf_counter()
    wavs = synth.synthesize_batch(texts, max_tokens=max_tokens)
    wall = time.perf_counter() - t0
    audio = sum(wav_seconds(w) for w in wavs)
    rep.batch = {
        "streams": len(texts),
        "audio_s": round(audio, 3),
        "wall_s": round(wall, 3),
        "rtf": round(wall / audio, 4) if audio else 0.0,
        "audio_per_wall": round(audio / wall, 2) if wall else 0.0,
    }
    if dev.type == "cuda":
        rep.peak_memory_gb = round(torch.cuda.max_memory_allocated(dev) / 1e9, 3)
    del synth
    return rep


def main(argv: list[str] | None = None) -> dict:
    """Print the report (a table, or one JSON line with ``--json``) and
    return it as a dict (``Report.as_dict``)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--model-dir", default=None, help="checkpoint directory")
    src.add_argument("--random-s1", action="store_true",
                     help="seeded random weights at S1-mini widths")
    src.add_argument("--tiny", action="store_true",
                     help="hermetic tiny random-weight model")
    ap.add_argument("--seed", type=int, default=0, help="weights seed (--random-s1, --tiny)")
    ap.add_argument("--precision", default="bf16",
                    choices=["bf16", "fp16", "fp32", "int8"])
    ap.add_argument("--max-tokens", type=int, default=None,
                    help="frames per call (default 64 with --tiny, else 2048)")
    ap.add_argument("--json", action="store_true", help="machine-readable output")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if not (args.model_dir or args.random_s1 or args.tiny):
        ap.error("one of --model-dir, --random-s1 or --tiny is required "
                 "(the port downloads nothing)")
    dev = resolve_device(args.device)

    rep = run(args, dev)
    print(rep.as_json() if args.json else rep.render(), flush=True)
    return rep.as_dict()


if __name__ == "__main__":
    main()
