"""Component-level decode profiling on one device.

The port's counterpart of ``scripts/profile_decode.py``: it times the pieces
of the per-frame budget separately, so that a regression can be attributed:

- "decode chunk (plain route)": the decode chunk with ``fast_kernel=False``;
- with int8 weights (the default off ``--tiny``; ``--bf16`` keeps bf16),
  "decode chunk (kernels)" and "kernel speedup".  The JAX script passes
  ``top_k=512`` to its chunk, so the reference's gates leave only the slow
  stack on its kernel there (the sampler kernel takes ``top_k == -1`` only,
  the fast decoder ``top_k <= 0``); the port keeps that, and each row names
  its route;
- "slow sampling (top_k=512)" (32 at ``--tiny``): ``engine/sampling.sample``
  over the whole vocabulary, one row at B = 1.

B = 1 at position 64 (16 at ``--tiny``), a kv read of ``min(max_seq_len,
512)`` rows, 20 frames a chunk, ``-n`` timed chunks after a warm one.  On
the card a chunk is the production path, a ``DecodeGraph`` replay per
frame, and the sampling loop of 20 calls is captured once in a CUDA graph
and replayed; both timed between CUDA events.  With ``--device cpu`` the
eager loops run, timed by the host's clock.

Usage: python -m fish_tts_tpu_torch.scripts.profile_decode [--tiny] [--bf16] [-n N]
       [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import torch

from fish_tts_tpu_torch.engine import decode
from fish_tts_tpu_torch.engine.sampling import sample
from fish_tts_tpu_torch.models.dual_ar import TokenIds
from fish_tts_tpu_torch.scripts._timing import (
    Chunks,
    Loop,
    device_line,
    free,
    lm,
    record,
    reset_state,
    resolve_device,
    time_loop,
)

FRAMES = 20
SAMPLING = (0.7, 0.8, 1.1)  # temperature, top_p, repetition penalty


def route_name(rt: decode.Route) -> str:
    on = [name for name, k in (("slow stack", rt.slow_stack), ("sampler", rt.sampler),
                               ("fast decoder", rt.fast)) if k]
    return "kernels: " + (", ".join(on) if on else "none")


def main(argv: list[str] | None = None) -> list[dict]:
    """Print one line per component and return them as records
    (``_timing.record``: label, value, unit, device, clock, how)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--bf16", action="store_true", help="skip int8 + kernels")
    ap.add_argument("-n", type=int, default=5, help="timing repetitions")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    tiny = args.tiny
    int8 = not args.bf16 and not tiny
    cfg, params, rope = lm(tiny, dev, int8)
    ids = TokenIds(400, 447, 5) if tiny else TokenIds(151672, 155767, 151661)
    top_k = 32 if tiny else 512
    kv_b = min(cfg.max_seq_len, 512)
    pos = 16 if tiny else 64
    print(f"# device={device_line(dev)} int8={int8} kernels={int8}", flush=True)
    records = []

    def time_chunk(label: str, fast_kernel: bool) -> float:
        state = reset_state(decode.init_state(params, cfg, batch=1), pos, 0, SAMPLING, 0)
        chunks = Chunks(params, cfg, ids, rope, state, frames=FRAMES, kv_bucket=kv_b,
                        skip_done=False, top_k=top_k, fast_kernel=fast_kernel)
        chunks()  # warm
        dt, _ = time_loop(chunks, dev, args.n)
        rt = decode.route(cfg, params, 1, decode.WINDOW, top_k=top_k, fast_kernel=fast_kernel)
        records.append(record(label, dt * 1e3, "ms/frame", dev, chunks.how,
                              route=route_name(rt)))
        print(f"{label:34s}: {dt*1e3:6.2f} ms/frame -> {1/dt:6.1f} tok/s  ({route_name(rt)})",
              flush=True)
        del chunks, state
        free(dev)
        return dt

    full_plain = time_chunk("decode chunk (plain route)", fast_kernel=False)
    if int8:
        full_k = time_chunk("decode chunk (kernels)", fast_kernel=True)
        records.append(record("kernel speedup", full_plain / full_k, "x", dev))
        print(f"{'kernel speedup':34s}: {full_plain / full_k:6.2f}x", flush=True)

    # sampling alone (slow-token top-p over the full vocab)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    logits = torch.randn((1, cfg.vocab_size), generator=gen, device=dev) * 4.0
    gumbel = decode.gumbel_from_uniform(
        torch.rand((FRAMES, 1, cfg.vocab_size), generator=gen, device=dev))
    cols = [torch.full((1, 1), v, device=dev) for v in SAMPLING]
    loop = Loop(lambda i: sample(gumbel[i], logits, *cols, prev_idx=None, top_k=top_k),
                FRAMES, dev)

    dt, note = time_loop(loop, dev, args.n)
    label = f"slow sampling (top_k={top_k})"
    records.append(record(label, dt * 1e3, "ms/frame", dev, loop.how))
    print(f"{label:34s}: {dt*1e3:6.2f} ms/frame{note}", flush=True)
    return records


if __name__ == "__main__":
    main()
