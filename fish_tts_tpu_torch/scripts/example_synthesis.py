"""Synthesis walkthrough: plain TTS, voice cloning, streaming, long text,
batching and continuous-batching serving.

Synthesize to WAV, clone from reference audio or a saved .npy profile,
stream with the first-chunk latency printed, all through ``FishTTS``.

    python -m fish_tts_tpu_torch.scripts.example_synthesis --text "Hello there"
    python -m fish_tts_tpu_torch.scripts.example_synthesis --text "Hi" --reference v.mp3 --transcript "..."
    python -m fish_tts_tpu_torch.scripts.example_synthesis --text "Hi" --profile v.npy --transcript "..." --stream
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

DEFAULT_TEXT = "Hello, this is a test of Fish TTS text to speech synthesis."


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--text", default=DEFAULT_TEXT)
    ap.add_argument("-o", "--output", type=Path, default=Path("output.wav"))
    ap.add_argument("--model-dir", default=None)
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    ap.add_argument("--precision", default="bf16",
                    choices=["bf16", "fp16", "fp32", "int8"])
    ap.add_argument("--temperature", type=float, default=0.7)
    ap.add_argument("--top-p", type=float, default=0.8)
    ap.add_argument("--stream", action="store_true",
                    help="stream PCM chunks and report first-chunk latency")
    ap.add_argument("--long", action="store_true",
                    help="long-form mode: sentence-aware chunking with "
                         "rolling voice-continuity context (for texts past "
                         "one model context window)")
    ap.add_argument("--max-chars", type=int, default=None,
                    help="per-chunk text budget for --long (default 200)")
    ap.add_argument("--carry-frames", type=int, default=None,
                    help="rolling audio-context frames for --long "
                         "(default 64)")
    ap.add_argument("--batch", nargs="+", metavar="TEXT",
                    help="synthesize several texts concurrently in one "
                         "batched decode; writes OUTPUT-0.wav, "
                         "OUTPUT-1.wav, ... (overrides --text)")
    ap.add_argument("--serve", nargs="+", metavar="TEXT",
                    help="continuous-batching demo: requests are SUBMITTED "
                         "STAGGERED (each after the previous has started "
                         "decoding) and join the running pool mid-flight; "
                         "writes OUTPUT-0.wav, ... (overrides --text)")
    ap.add_argument("--slots", type=int, default=4,
                    help="serving pool size for --serve")

    clone = ap.add_argument_group("voice cloning")
    clone.add_argument("-r", "--reference", type=Path,
                       help="reference audio to clone (any ffmpeg format)")
    clone.add_argument("-p", "--profile", type=Path,
                       help="saved voice profile (.npy)")
    clone.add_argument("-t", "--transcript",
                       help="what the reference audio says (required to clone)")
    args = ap.parse_args(argv)

    if args.reference and args.profile:
        ap.error("--reference and --profile are mutually exclusive")
    if (args.reference or args.profile) and not args.transcript:
        ap.error("cloning needs --transcript")
    # modes must not silently override each other
    if args.batch and args.serve:
        ap.error("--batch and --serve are mutually exclusive")
    if args.stream and (args.batch or args.serve):
        ap.error("--stream applies to single-text modes; --batch/--serve "
                 "stream per request already")
    if args.long and (args.batch or args.serve):
        ap.error("--long is a single-text mode (serve_http supports "
                 "long=true per request)")
    if (args.max_chars is not None or args.carry_frames is not None) \
            and not args.long:
        ap.error("--max-chars/--carry-frames only apply to --long")
    if args.max_chars is None:
        args.max_chars = 200
    if args.carry_frames is None:
        args.carry_frames = 64
    return args


def build_references(args, synth):
    """None, or a one-element list with the requested voice."""
    if args.reference:
        from fish_tts_tpu_torch.utils.audio import load_audio_bytes

        return [synth.encode_reference(load_audio_bytes(args.reference),
                                       args.transcript)]
    if args.profile:
        from fish_tts_tpu_torch import VoiceProfile

        return [VoiceProfile.load(args.profile, text=args.transcript)]
    return None


def synthesize_streaming(args, synth, references) -> bytes:
    from fish_tts_tpu_torch.utils.audio import wav_header

    pcm = bytearray()
    started = time.perf_counter()
    ttfa = None
    for chunk in synth.synthesize_stream(
        args.text, references=references,
        temperature=args.temperature, top_p=args.top_p,
    ):
        if ttfa is None:
            ttfa = time.perf_counter() - started
            print(f"first audio after {ttfa * 1e3:.0f} ms")
        pcm.extend(chunk)
    # wrap the streamed int16 PCM as-is: a float round trip would clip
    # legitimate -32768 samples to -32767
    return wav_header(synth.sample_rate, len(pcm)) + bytes(pcm)


def serve_demo(args, synth, references) -> int:
    """Continuous batching: requests join the RUNNING decode pool.

    Each text is submitted only after the previous request has produced its
    first audio, so later requests genuinely admit mid-flight (the thing
    static ``--batch`` cannot do).  Audio streams per request through the
    public ``FishTTS.serve`` session (per-request stateful vocoder states).
    """
    import numpy as np

    from fish_tts_tpu_torch.utils.audio import wav_header

    if references is not None:
        synth.set_references(references)
    sess = synth.serve(slots=args.slots)
    texts = list(args.serve)
    t0 = time.perf_counter()
    rid_to_idx = {sess.submit(
        texts[0], temperature=args.temperature, top_p=args.top_p
    ): 0}
    started = {0: time.perf_counter()}
    next_idx = 1
    pcm: dict[int, bytearray] = {}
    first_at: dict[int, float] = {}
    finished: set[int] = set()
    while sess.busy or next_idx < len(texts):
        for ev in sess.step():
            idx = rid_to_idx[ev.request_id]
            if idx not in first_at and ev.pcm:
                first_at[idx] = time.perf_counter() - started[idx]
            pcm.setdefault(idx, bytearray()).extend(ev.pcm)
            if ev.done:
                finished.add(idx)
                print(f"req {idx}: {ev.frames_total} frames, first audio "
                      f"after {first_at.get(idx, 0) * 1e3:.0f} ms")
        # stagger: admit the next request only once the previous one has
        # produced its FIRST audio, so later submissions genuinely join a
        # running decode (submitting every round would just refill the
        # queue up front, like static --batch).  A frame-less finish also
        # unblocks the chain (no audio will ever come from it).
        if next_idx < len(texts) and (
            (next_idx - 1) in first_at or (next_idx - 1) in finished
        ):
            rid = sess.submit(texts[next_idx], temperature=args.temperature,
                              top_p=args.top_p)
            rid_to_idx[rid] = next_idx
            started[next_idx] = time.perf_counter()
            next_idx += 1
    wall = time.perf_counter() - t0
    total_audio = 0.0
    for idx, buf in sorted(pcm.items()):
        samples = np.frombuffer(bytes(buf), np.int16)
        wav = wav_header(synth.sample_rate, len(buf)) + bytes(buf)
        out = args.output.with_name(f"{args.output.stem}-{idx}.wav")
        out.write_bytes(wav)
        audio_s = samples.size / 44100
        total_audio += audio_s
        print(f"{out}: {audio_s:.1f}s audio")
    print(f"served {len(texts)} staggered requests over {args.slots} slots: "
          f"{total_audio:.1f}s audio in {wall:.2f}s "
          f"(aggregate RTF {wall / max(total_audio, 1e-9):.3f})")
    st = sess.stats()
    print(f"scheduler: {st['completed']} completed, "
          f"queue wait p50 {st.get('queue_wait_p50_s', 0):.3f}s, "
          f"TTFT p50 {st.get('ttft_p50_s', 0):.3f}s / "
          f"p95 {st.get('ttft_p95_s', 0):.3f}s")
    return 0


def main(argv=None) -> int:
    args = parse_args(argv)

    from fish_tts_tpu_torch import get_instance

    synth = get_instance(
        model_dir=args.model_dir, device=args.device, precision=args.precision
    )
    references = build_references(args, synth)

    t0 = time.perf_counter()
    if args.serve:
        return serve_demo(args, synth, references)
    if args.batch:
        wavs = synth.synthesize_batch(
            args.batch, references=references,
            temperature=args.temperature, top_p=args.top_p,
        )
        wall = time.perf_counter() - t0
        total_audio = 0.0
        for i, w in enumerate(wavs):
            out = args.output.with_name(f"{args.output.stem}-{i}.wav")
            out.write_bytes(w)
            audio_s = (len(w) - 44) / (44100 * 2)
            total_audio += audio_s
            print(f"{out}: {audio_s:.1f}s audio")
        print(f"batched: {total_audio:.1f}s total audio in {wall:.2f}s "
              f"(aggregate RTF {wall / total_audio:.3f})")
        return 0
    if args.long and args.stream:
        from fish_tts_tpu_torch.utils.audio import wav_header

        pcm = bytearray()
        ttfa = None
        for chunk in synth.synthesize_long_stream(
            args.text, references=references,
            temperature=args.temperature, top_p=args.top_p,
            max_chars=args.max_chars, carry_frames=args.carry_frames,
        ):
            if ttfa is None:
                ttfa = time.perf_counter() - t0
                print(f"first audio after {ttfa * 1e3:.0f} ms")
            pcm.extend(chunk)
        wav = wav_header(synth.sample_rate, len(pcm)) + bytes(pcm)
    elif args.long:
        wav = synth.synthesize_long(
            args.text, references=references,
            temperature=args.temperature, top_p=args.top_p,
            max_chars=args.max_chars, carry_frames=args.carry_frames,
        )
    elif args.stream:
        wav = synthesize_streaming(args, synth, references)
    else:
        wav = synth.synthesize(
            args.text, references=references,
            temperature=args.temperature, top_p=args.top_p,
        )
    wall = time.perf_counter() - t0

    args.output.write_bytes(wav)
    audio_s = (len(wav) - 44) / (44100 * 2)
    rtf = wall / audio_s if audio_s else float("inf")
    print(f"{args.output}: {audio_s:.1f}s audio in {wall:.2f}s (RTF {rtf:.3f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
