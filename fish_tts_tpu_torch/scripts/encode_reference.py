"""Create a voice profile (.npy) from reference audio.

Non-WAV input is transcoded through ffmpeg; the transcript comes from an
argument or a file; the profile goes next to the audio unless ``-o`` names
it.  Audio loading is ``utils.audio.load_audio_bytes``, encoding
``FishTTS.encode_reference``.

    python -m fish_tts_tpu_torch.scripts.encode_reference voice.wav "What the speaker says"
    python -m fish_tts_tpu_torch.scripts.encode_reference voice.mp3 -t transcript.txt -o out.npy
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("audio", type=Path, help="reference audio (any ffmpeg format)")
    ap.add_argument("transcript", nargs="?", default=None,
                    help="what the reference audio says")
    ap.add_argument("-t", "--transcript-file", type=Path,
                    help="read the transcript from a text file")
    ap.add_argument("-o", "--output", type=Path,
                    help="profile path (default: alongside the audio)")
    ap.add_argument("--name", default="", help="profile display name")
    ap.add_argument("--model-dir", default=None)
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    ap.add_argument("--precision", default="bf16", choices=["bf16", "fp16", "fp32", "int8"])
    return ap.parse_args(argv)


def resolve_transcript(args) -> str:
    if args.transcript_file is not None:
        return args.transcript_file.read_text(encoding="utf-8").strip()
    if args.transcript:
        return args.transcript
    raise SystemExit("a transcript is required (positional or --transcript-file)")


def main(argv=None) -> int:
    args = parse_args(argv)
    transcript = resolve_transcript(args)
    if not args.audio.exists():
        raise SystemExit(f"audio file not found: {args.audio}")

    from fish_tts_tpu_torch import get_instance
    from fish_tts_tpu_torch.utils.audio import load_audio_bytes

    try:
        wav_bytes = load_audio_bytes(args.audio)
    except RuntimeError as e:
        raise SystemExit(str(e)) from e

    synth = get_instance(model_dir=args.model_dir, device=args.device,
                         precision=args.precision, warmup=False)
    profile = synth.encode_reference(wav_bytes, transcript)
    if args.name:
        profile.name = args.name

    out = args.output or args.audio.with_suffix(".npy")
    profile.save(out)
    n_frames = profile.codes.shape[1]
    print(f"{out}: {profile.codes.shape[0]} codebooks x {n_frames} frames "
          f"({n_frames / 21.53:.1f}s of reference audio)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
