"""Convert a reference checkpoint directory (config.json, model.pth,
codec.pth, tokenizer.tiktoken) into the native format (lm.safetensors,
vocoder.safetensors, vocoder_config.json), which loads without unpickling.
Either package reads the result.

Usage: python -m fish_tts_tpu_torch.scripts.convert_checkpoint <model_dir> <out_dir>
       [--lm-dtype bf16|fp32] [--vocoder-dtype bf16|fp32] [--verify]
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("model_dir")
    ap.add_argument("out_dir")
    ap.add_argument("--lm-dtype", default="bf16", choices=["bf16", "fp32"],
                    help="LM storage dtype (model.pth ships bf16, so the default loses "
                         "nothing)")
    ap.add_argument("--vocoder-dtype", default="fp32", choices=["bf16", "fp32"],
                    help="codec storage dtype (fp32, the default, loses nothing)")
    ap.add_argument("--verify", action="store_true",
                    help="print the key-coverage report (consumed / expected drops / "
                         "unconsumed) and exit non-zero if a checkpoint key was left "
                         "unconsumed")
    args = ap.parse_args(argv)

    from fish_tts_tpu_torch.utils.checkpoint import convert_checkpoint_dir

    reports = convert_checkpoint_dir(args.model_dir, args.out_dir, lm_dtype=args.lm_dtype,
                                     vocoder_dtype=args.vocoder_dtype)
    print(f"Converted {args.model_dir} -> {args.out_dir}")
    if args.verify:
        bad = False
        for name, rep in reports.items():
            print(f"[{name}] {rep.summary()}")
            bad |= not rep.ok
        if bad:
            print("VERIFY FAILED: unconsumed checkpoint keys (see above)")
            raise SystemExit(1)
        print("VERIFY OK: every checkpoint key consumed or expected-dropped")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
