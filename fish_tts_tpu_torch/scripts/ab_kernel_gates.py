"""A/B each kernel's in-chunk contribution at a given batch size.

The port's counterpart of ``scripts/ab_kernel_gates.py``: the production
decode chunk, with one kernel's gate turned off at a time.  Timing a kernel
alone (``profile_batch``) leaves out what it costs in context; this times
the real thing.

``decode.route`` reads each kernel module's ``supports`` when it is called,
and a ``DecodeGraph`` fixes its route when it is captured, so each gate
setting gets a freshly reset state (``pos`` = ``--pos``, ``step`` = pos -
10, as the JAX script's ``fresh()``) and a fresh graph.  ``supports`` is
restored in a ``finally``, on an exception too.  Each row is ``--chunks``
chunks of 20 frames after one warm chunk, the least of 3 runs, on the card
between CUDA events (on the CPU, the eager loop on the host's clock).  Each
row also gives each kernel's launches over its warm and timed chunks: the
gated-off kernel 0, every other one per decode frame (on the CPU the
kernels' plain versions run and count nothing).

Usage: python -m fish_tts_tpu_torch.scripts.ab_kernel_gates [-b 16] [--kv 256]
       [--pos 130] [--chunks 5] [--tiny] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

from fish_tts_tpu_torch.engine import decode
from fish_tts_tpu_torch.models.dual_ar import TokenIds
from fish_tts_tpu_torch.ops import fast_decoder, sampler_kernel, slow_stack
from fish_tts_tpu_torch.scripts._timing import (
    Chunks,
    clock_name,
    device_line,
    free,
    lm,
    reset_state,
    resolve_device,
    timed,
)

CHUNK = 20
SAMPLING = (0.7, 0.8, 1.2)  # temperature, top_p, repetition penalty (the JAX script's)
# each kernel module with its name in the launch records
KERNELS = ((sampler_kernel, "sample_slow"), (fast_decoder, "fast_decode_frame"),
           (slow_stack, "slow_stack_step"))
GATES = {
    "all kernels (production)": (),
    "sampler kernel OFF": (sampler_kernel,),
    "fast-decoder kernel OFF": (fast_decoder,),
    "slow-stack kernel OFF": (slow_stack,),
}


def ab_ids(cfg) -> TokenIds:
    """The A/B scripts' token ids: the semantic range at the vocabulary's top."""
    return TokenIds(cfg.vocab_size - 1 - cfg.codebook_size, cfg.vocab_size - 1, 5)


def launches() -> dict[str, int]:
    """Each kernel's launch counter (the tied-head slow stack)."""
    return {name: mod.launches for mod, name in KERNELS}


def frames_run() -> int:
    """Decode frames run so far on either route (graph replays, eager frames)."""
    return decode.graph_replays + decode.eager_frames


def time_chunks(chunks: Chunks, state, args, seed: int, dev) -> tuple[float, list[float]]:
    """One warm chunk, then the least of 3 runs of ``args.chunks`` chunks,
    each from the state reset to ``args.pos``.  Returns (seconds per frame,
    every run's seconds)."""
    def fresh():
        reset_state(state, args.pos, args.pos - 10, SAMPLING, seed)

    fresh()
    chunks()  # warm

    def run():
        for _ in range(args.chunks):
            chunks()

    times = []
    for _ in range(3):
        fresh()
        times.append(timed(run, dev)[0])
    return min(times) / (args.chunks * CHUNK), times


def main(argv: list[str] | None = None) -> list[dict]:
    """Print one line per gate setting and return them as records:
    {"label", "ms_per_frame", "aggregate_frames_per_s", "times_s", "route",
    "frames", "launches", "device", "clock"}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-b", type=int, default=16)
    ap.add_argument("--kv", type=int, default=256)
    ap.add_argument("--pos", type=int, default=130)
    ap.add_argument("--chunks", type=int, default=5)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg, params, rope = lm(args.tiny, dev, int8=True)
    ids = ab_ids(cfg)
    B = args.b
    if args.pos + args.chunks * CHUNK > args.kv:
        raise ValueError(f"decode contract: pos {args.pos} + {args.chunks} chunks of {CHUNK} "
                         f"frames exceeds the kv bucket {args.kv}")
    card = device_line(dev)
    print(f"# device={card} B={B} kv={args.kv} pos={args.pos}", flush=True)
    state = decode.init_state(params, cfg, batch=B)

    originals = {mod: mod.supports for mod, _ in KERNELS}
    records = []
    try:
        for label, off in GATES.items():
            for mod, orig in originals.items():
                mod.supports = (lambda *a, **k: False) if mod in off else orig
            rt = decode.route(cfg, params, B, decode.WINDOW, top_k=-1, fast_kernel=True)
            reset_state(state, args.pos, args.pos - 10, SAMPLING, 1)
            chunks = Chunks(params, cfg, ids, rope, state, frames=CHUNK, kv_bucket=args.kv,
                            skip_done=True, top_k=-1, fast_kernel=True)
            before, frames0 = launches(), frames_run()
            per_frame, times = time_chunks(chunks, state, args, 1, dev)
            counts = {k: n - before[k] for k, n in launches().items()}
            rec = {"label": label, "ms_per_frame": per_frame * 1e3,
                   "aggregate_frames_per_s": B / per_frame, "times_s": times,
                   "route": {"slow_stack": rt.slow_stack, "sampler": rt.sampler,
                             "fast": rt.fast},
                   "frames": frames_run() - frames0, "launches": counts,
                   "device": card, "clock": clock_name(dev)}
            records.append(rec)
            print(f"{label:28s}: {rec['ms_per_frame']:.3f} ms/frame -> "
                  f"{rec['aggregate_frames_per_s']:.0f} aggregate tok/s  "
                  f"(times {[round(x, 3) for x in times]}) launches {counts} over "
                  f"{rec['frames']} frames", flush=True)
            del chunks
            free(dev)
    finally:
        for mod, orig in originals.items():
            mod.supports = orig
    return records


if __name__ == "__main__":
    main()
