"""A/B the fast-decoder kernel's dequant modes.

The port's counterpart of ``scripts/ab_fast_decoder.py``: it times
``ops.fast_decoder.fast_decode_frame`` directly, not through the engine's
gate, for each dequant mode at each batch size.  A run is FRAMES frames,
each frame's first residual code fed forward as the next frame's ``a0``
(a real dependency chain), from a zero hidden state and zero penalty
windows, with Gumbel noise drawn from a seed before the timing.  On the card
the runs are timed with CUDA events and the kernels launch (``"value"`` and
``"scratch"`` the ``"value"`` variant, ``"s8"`` its own); with
``--device cpu`` the plain versions run, timed by the host's clock.

Usage: python -m fish_tts_tpu_torch.scripts.ab_fast_decoder [-b 1 8 16] [-n N]
       [--modes ...] [--tiny] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import torch

from fish_tts_tpu_torch.engine.decode import gumbel_from_uniform
from fish_tts_tpu_torch.ops import fast_decoder
from fish_tts_tpu_torch.scripts._timing import device_line, lm, resolve_device, timed

FRAMES = 20
WINDOW = 16
SAMPLING = (0.7, 0.8, 1.1)  # temperature, top_p, repetition penalty


def main(argv: list[str] | None = None) -> list[dict]:
    """Print one line per (batch, mode) and return them as records:
    {"B", "dequant", "ms_per_frame", "frames_per_s", "aggregate_frames_per_s"}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-b", type=int, nargs="+", default=[1, 8, 16])
    ap.add_argument("-n", type=int, default=10, help="timed runs of FRAMES frames")
    ap.add_argument("--modes", nargs="+", default=None)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg, params, rope = lm(args.tiny, dev, int8=True)
    rope = rope["fast"]
    modes = args.modes or list(fast_decoder.DEQUANT_MODES)
    K, Vr = cfg.num_codebooks, cfg.residual_codebook_size
    print(f"# device={device_line(dev)} cfg={'tiny' if args.tiny else 's1'} "
          f"frames/run={FRAMES}", flush=True)
    gen = torch.Generator(device=dev)
    records = []
    for B in args.b:
        print(f"# B={B} supports={fast_decoder.supports(cfg, params, B, WINDOW)}", flush=True)
        h = torch.zeros((B, cfg.fast_dim), dtype=torch.float32, device=dev)
        prev = torch.zeros((B, K - 1, WINDOW), dtype=torch.int32, device=dev)
        for mode in modes:
            gen.manual_seed(B)
            noise = [gumbel_from_uniform(torch.rand((B, K - 1, Vr), generator=gen, device=dev))
                     for _ in range(FRAMES)]

            def run(mode=mode, B=B, noise=noise):
                a0 = torch.zeros((B,), dtype=torch.int32, device=dev)
                for g in noise:
                    codes, _ = fast_decoder.fast_decode_frame(
                        params, cfg, rope, h, a0, prev, g, *SAMPLING, window=WINDOW,
                        dequant=mode)
                    a0 = codes[:, 0].contiguous()
                return a0

            run()  # warm-up

            def runs(run=run):
                for _ in range(args.n):
                    run()

            dt = timed(runs, dev)[0] / (args.n * FRAMES)
            rec = {"B": B, "dequant": mode, "ms_per_frame": dt * 1e3,
                   "frames_per_s": 1 / dt, "aggregate_frames_per_s": B / dt}
            records.append(rec)
            print(f"B={B} dequant={mode:8s}: {rec['ms_per_frame']:8.4f} ms/frame -> "
                  f"{rec['frames_per_s']:9.1f} frames/s, {rec['aggregate_frames_per_s']:9.1f} "
                  f"aggregate", flush=True)
    return records


if __name__ == "__main__":
    main()
