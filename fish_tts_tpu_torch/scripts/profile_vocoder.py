"""Component attribution of the pool codec's chunk at the serving shape.

The port's counterpart of ``scripts/profile_vocoder.py``: at B slots x F
frames (16 x 20, the serving pool's codec shape) it times

- the whole ``dac_decode`` chunk,
- ``decoder_forward`` alone (the conv stack with its upsamples),
- every snake, conv and transposed conv at its exact shape in the decoder,
  through ``ops/conv`` (cuDNN on the card) and ``ops/norms.snake``,

then prints the totals by kind and the whole chunk.  Each is a loop of 8
calls, captured once in a CUDA graph on the card and replayed, timed between
CUDA events; with ``--device cpu`` the eager loops run on the host's clock
(``ops/conv.conv1d`` runs strided reduced-precision shapes in float32 there;
the tiny config is float32 throughout).  The codec's weights are drawn from
a seed, bf16 at the full width, float32 at ``--tiny``.

Usage: python -m fish_tts_tpu_torch.scripts.profile_vocoder [-b 16] [-f 20] [-n 5]
       [--tiny] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import torch

from fish_tts_tpu_torch.config import TINY_VOCODER_CONFIG, VocoderConfig
from fish_tts_tpu_torch.models import vocoder as voc
from fish_tts_tpu_torch.ops.conv import causal_conv1d, causal_conv_transpose1d
from fish_tts_tpu_torch.ops.norms import snake
from fish_tts_tpu_torch.scripts._timing import (
    Loop,
    device_line,
    free,
    record,
    resolve_device,
    time_loop,
)

REPS = 8  # calls per timed loop


def main(argv: list[str] | None = None) -> list[dict]:
    """Print one line per stage and the totals; return the stage records
    (``_timing.record``: label, value in ms per call, device, clock, how)
    and a last record "totals" with ``snake_ms``, ``conv_ms``, ``up_ms``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-b", type=int, default=16)
    ap.add_argument("-f", type=int, default=20, help="frames per chunk")
    ap.add_argument("-n", type=int, default=5)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = TINY_VOCODER_CONFIG if args.tiny else VocoderConfig()
    dtype = torch.float32 if args.tiny else torch.bfloat16
    B, F = args.b, args.f
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = voc.init_vocoder_params(gen, cfg, dtype=dtype)
    print(f"# device={device_line(dev)} B={B} F={F} dtype={str(dtype).split('.')[-1]}",
          flush=True)
    records = []

    def timeit(label: str, fn) -> float:
        """ms of one ``fn()``, over ``-n`` replays of a loop of REPS calls."""
        loop = Loop(lambda i: fn(), REPS, dev)
        per, note = time_loop(loop, dev, args.n)
        records.append(record(label, per * 1e3, "ms", dev, loop.how))
        print(f"{label:44s}: {per*1e3:8.3f} ms{note}", flush=True)
        del loop
        free(dev)
        return per * 1e3

    # whole chunk through the codec
    codes = torch.randint(0, cfg.residual_codebook_size, (B, cfg.num_codebooks, F),
                          generator=gen, device=dev)
    with torch.no_grad():
        total = timeit("dac_decode (full pool chunk)", lambda: voc.dac_decode(params, cfg, codes))
        z = voc.quantizer_decode(params["quantizer"], cfg, codes)
        dp = params["decoder"]
        timeit("decoder_forward (conv stack)", lambda: voc.decoder_forward(dp, cfg, z))

        # per-stage attribution at exact shapes
        x = causal_conv1d(z, dp["stem"]["w"], dp["stem"]["b"])
        snake_t = conv_t = up_t = 0.0
        for bi, (block, stride) in enumerate(zip(dp["blocks"], cfg.decoder_rates)):
            c_in, t_in = x.shape[1], x.shape[2]
            snake_t += timeit(f"  block{bi} snake ({c_in}x{t_in})",
                              lambda x=x, p=block: snake(x, p["snake"]))
            up_t += timeit(f"  block{bi} up-conv_t (s={stride})",
                           lambda x=x, p=block, s=stride: causal_conv_transpose1d(
                               x, p["up"]["w"], p["up"]["b"], stride=s))
            x = causal_conv_transpose1d(x, block["up"]["w"], block["up"]["b"], stride=stride)
            for dil, unit in zip((1, 3, 9), block["units"]):
                c_u, t_u = x.shape[1], x.shape[2]
                snake_t += 2 * timeit(f"  block{bi} unit snake ({c_u}x{t_u})",
                                      lambda x=x, p=unit: snake(x, p["snake1"]))
                conv_t += timeit(f"  block{bi} unit conv7 d={dil} ({c_u}x{t_u})",
                                 lambda x=x, p=unit, d=dil: causal_conv1d(
                                     x, p["conv1"]["w"], p["conv1"]["b"], dilation=d))
                conv_t += timeit(f"  block{bi} unit conv1 ({c_u}x{t_u})",
                                 lambda x=x, p=unit: causal_conv1d(
                                     x, p["conv2"]["w"], p["conv2"]["b"]))
                x = voc._residual_unit(unit, x, dil)
        c_f, t_f = x.shape[1], x.shape[2]
        snake_t += timeit(f"  final snake ({c_f}x{t_f})",
                          lambda x=x: snake(x, dp["final_snake"]))
        conv_t += timeit(f"  final conv ({c_f}x{t_f})",
                         lambda x=x: causal_conv1d(x, dp["final_conv"]["w"],
                                                   dp["final_conv"]["b"]))

    print(f"# totals: snake {snake_t:.2f} ms, unit/final convs {conv_t:.2f} ms, up-convs "
          f"{up_t:.2f} ms, whole chunk {total:.2f} ms", flush=True)
    records.append(record("totals", total, "ms", dev, "sum of the rows", snake_ms=snake_t,
                          conv_ms=conv_t, up_ms=up_t))
    return records


if __name__ == "__main__":
    main()
