"""A/B the KV read window (the kv bucket) of the batched decode chunk at the
serving shape.

The port's counterpart of ``scripts/ab_kvbucket.py``: serving-shaped
requests (a short prompt and ~200 generated frames) live at ~250 context
rows, and the attention of every frame reads ``kv_bucket`` cache rows per
layer per stream, so ``EngineConfig.kv_bucket_step`` sets how many rows a
round streams.  This times the same production decode chunk (a
``DecodeGraph`` replayed, int8 weights and every kernel, B = 16) at each
``--buckets`` read window, ``--chunks`` chunks of 20 frames after one warm
chunk, the least of 3 runs from a state reset to ``--pos``, between CUDA
events on the card (on the CPU, the eager loop on the host's clock).

It keeps the reference's decode contract ``pos + frames <= kv_bucket``: a
bucket that breaks it is skipped, since a truncated read window is faster
and wrong.  With the default ``--pos 210`` the 256 bucket is skipped; at
``--pos 130`` both buckets run.

Usage: python -m fish_tts_tpu_torch.scripts.ab_kvbucket [-b 16] [--buckets 512 256]
       [--pos 210] [--chunks 5] [--tiny] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

from fish_tts_tpu_torch.engine import decode
from fish_tts_tpu_torch.scripts._timing import (
    Chunks,
    clock_name,
    device_line,
    free,
    lm,
    reset_state,
    resolve_device,
)
from fish_tts_tpu_torch.scripts.ab_kernel_gates import (
    CHUNK,
    SAMPLING,
    ab_ids,
    launches,
    time_chunks,
)


def main(argv: list[str] | None = None) -> list[dict]:
    """Print one line per bucket and return the records of the buckets that
    ran: {"kv_bucket", "ms_per_frame", "aggregate_frames_per_s", "times_s",
    "launches", "device", "clock"}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-b", type=int, default=16, help="batch size")
    ap.add_argument("--buckets", type=int, nargs="+", default=[512, 256])
    ap.add_argument("--pos", type=int, default=210,
                    help="per-stream live context rows at the timed chunks")
    ap.add_argument("--chunks", type=int, default=5)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg, params, rope = lm(args.tiny, dev, int8=True)
    ids = ab_ids(cfg)
    B = args.b
    card = device_line(dev)
    print(f"# device={card} B={B} pos={args.pos}", flush=True)
    state = decode.init_state(params, cfg, batch=B)
    records = []
    for kv_b in args.buckets:
        if args.pos + args.chunks * CHUNK > kv_b:
            print(f"kv_bucket={kv_b}: skipped (pos+frames exceeds bucket)", flush=True)
            continue
        reset_state(state, args.pos, args.pos - 10, SAMPLING, 1)
        chunks = Chunks(params, cfg, ids, rope, state, frames=CHUNK, kv_bucket=kv_b,
                        skip_done=True, top_k=-1, fast_kernel=True)
        before = launches()
        per_frame, times = time_chunks(chunks, state, args, 1, dev)
        rec = {"kv_bucket": kv_b, "ms_per_frame": per_frame * 1e3,
               "aggregate_frames_per_s": B / per_frame, "times_s": times,
               "launches": {k: n - before[k] for k, n in launches().items()},
               "device": card, "clock": clock_name(dev)}
        records.append(rec)
        print(f"kv_bucket={kv_b}: {rec['ms_per_frame']:.3f} ms/frame -> "
              f"{rec['aggregate_frames_per_s']:.0f} aggregate tok/s  "
              f"(times {[round(x, 3) for x in times]})", flush=True)
        del chunks
        free(dev)
    return records


if __name__ == "__main__":
    main()
