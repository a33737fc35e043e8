"""Streaming TTS HTTP server over the continuous-batching engine.

    python -m fish_tts_tpu_torch.scripts.serve_http --model-dir /path/to/openaudio-s1-mini \
        --slots 16 --port 8080

    curl -N -X POST localhost:8080/synthesize \
        -d '{"text": "hello world", "max_new_tokens": 400}' \
        -o out.pcm          # raw s16le mono; sample rate in X-Sample-Rate
    curl localhost:8080/stats
    curl -X DELETE localhost:8080/requests/3

Requests join the running decode pool mid-flight (``engine/serve.py``) and
their PCM streams as it is decoded.  ``--vocoder-device-index`` refuses any
value: the port serves on one card.
"""

from __future__ import annotations

import argparse
import logging
import signal
import threading
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model-dir", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--slots", type=int, default=16)
    ap.add_argument("--max-queue", type=int, default=64)
    ap.add_argument("--precision", default="int8", choices=("int8", "bf16", "fp32"))
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the warmup (the first requests capture the decode graphs "
                         "instead)")
    ap.add_argument("--drain-timeout", type=float, default=30.0,
                    help="seconds to finish in-flight requests on shutdown")
    ap.add_argument("--vocoder-device-index", type=int, default=None,
                    help="a second card for the pool codec (refused: the port serves on "
                         "one card)")
    ap.add_argument("--voices", default=None,
                    help="directory of <name>.npy voice profiles (optional <name>.txt "
                         "transcripts) served as per-request voices via the JSON 'voice' "
                         "field")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from fish_tts_tpu_torch import VoiceProfile, get_instance
    from fish_tts_tpu_torch.serving.http import make_server
    from fish_tts_tpu_torch.synthesizer import ONE_CARD_VOCODER

    # refuse before the model load, which would otherwise run only to fail
    if args.vocoder_device_index is not None:
        ap.error(f"--vocoder-device-index {args.vocoder_device_index}: {ONE_CARD_VOCODER}")

    voices = {}
    if args.voices:
        for npy in sorted(Path(args.voices).glob("*.npy")):
            txt = npy.with_suffix(".txt")
            text = txt.read_text().strip() if txt.exists() else ""
            voices[npy.stem] = VoiceProfile.load(npy, text=text)
        logging.info("loaded %d voices: %s", len(voices), sorted(voices))

    tts = get_instance(model_dir=args.model_dir, precision=args.precision, device=args.device,
                       warmup=not args.no_warmup)
    srv, driver = make_server(tts, host=args.host, port=args.port, slots=args.slots,
                              max_queue=args.max_queue, voices=voices)
    logging.info("serving on http://%s:%d (slots=%d, max_queue=%d)", args.host, args.port,
                 args.slots, args.max_queue)

    # SIGTERM drains: stop accepting, finish in-flight requests (bounded), exit
    def _term(_sig, _frm):
        logging.info("SIGTERM: draining and shutting down")
        threading.Thread(target=srv.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _term)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        clean = driver.close(drain=True, timeout=args.drain_timeout)
        if clean:
            logging.info("drained cleanly")
        else:
            logging.warning("exited with truncated in-flight streams (drain exceeded "
                            "--drain-timeout %.0fs)", args.drain_timeout)
        srv.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
