"""HTTP serving front end over :class:`~fish_tts_tpu_torch.synthesizer.ServeSession`.

The port's own copy of ``fish_tts_tpu/serving/http.py``: a streaming TTS
server on the standard library's ``http.server`` over the port's
continuous-batching session.

Endpoints:

- ``POST /synthesize``: JSON ``{"text": ..., "max_new_tokens": ...,
  "temperature": ..., "top_p": ..., "repetition_penalty": ..., "seed": ...,
  "voice": ..., "priority": ..., "timeout_s": ..., "format": ...,
  "long": ..., "max_chars": ..., "carry_frames": ...}`` (all but ``text``
  optional).  Responds with chunked ``audio/L16`` (int16 little-endian PCM
  streamed as the pool decodes it; headers ``X-Sample-Rate`` and
  ``X-Request-Id``), or ``audio/wav`` with ``"format": "wav"`` (an
  unknown-length RIFF header, then the same PCM).  ``"long": true`` decodes
  the text as a chain of sentence-aware chunks streamed as one response.
  ``voice`` names a :class:`VoiceProfile` of the server's registry.
- ``GET /voices``: the registry's names.
- ``PUT /voices/<name>``: register a voice from ``{"wav_b64": ...,
  "text": ...}`` through the instance's ``encode_reference`` (the codec
  encoder); 501 from a handler built without one.
- ``POST /v1/audio/speech``: the OpenAI-compatible speech endpoint
  (``{"model", "input", "voice", "response_format": "wav"|"pcm",
  "speed": 1.0}``); unknown voice names fall back to the default voice;
  ``wav`` answers with one complete file, ``pcm`` streams at the model's
  own rate.  Native extras (``temperature``, ``seed``, ...) pass through.
- ``GET /stats``: the scheduler's stats as JSON; ``GET /metrics``: the
  same as Prometheus gauges (``fish_tts_*``).
- ``DELETE /requests/<id>``: cancel a queued or running request.
- ``GET /healthz``: liveness.

Threads: the server's handler threads only submit and consume (one
unbounded queue per request, a slow consumer is cancelled); one driver
thread calls ``session.step()``, so all device work runs on one thread, on
the session's CUDA stream.  ``max_queue`` makes ``submit`` raise
``QueueFull``, answered with 503.
"""


from __future__ import annotations

import json
import logging
import queue
import threading
import time
from http import HTTPStatus
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from fish_tts_tpu_torch.engine.serve import QueueFull
from fish_tts_tpu_torch.utils.audio import streaming_wav_header, wav_header

logger = logging.getLogger(__name__)

_DONE = object()  # end-of-stream sentinel on per-request queues


class ServeDriver:
    """Owns a :class:`ServeSession` and the single device-driving thread;
    routes per-request PCM to bounded consumer queues."""

    def __init__(self, session, poll_idle_s: float = 0.002,
                 consumer_queue_chunks: int = 64):
        self._sess = session
        self._idle = poll_idle_s
        self._qsize = consumer_queue_chunks
        self._lock = threading.Lock()
        self._consumers: dict[int, queue.Queue] = {}
        self._stop = threading.Event()
        self._drain = threading.Event()
        self._thread = threading.Thread(
            target=self._drive, name="fish-tts-serve-driver", daemon=True
        )
        self._thread.start()

    # -- public -------------------------------------------------------------

    def submit(self, text: str, **kw) -> tuple[int, queue.Queue]:
        """Submit a request; returns (request_id, per-request queue yielding
        PCM ``bytes`` chunks then the done sentinel).  Raises ``QueueFull``
        under backpressure."""
        q: queue.Queue = queue.Queue()  # unbounded: the driver never blocks
        # expensive prep (tokenize/prompt/keys) OUTSIDE the routing lock —
        # holding it would stall PCM delivery for every live stream during
        # a submit burst.  Registration is atomic with the cheap enqueue
        # under the routing lock, so a fast request (warm caches) cannot
        # complete and drop its events before its consumer exists.
        req = self._sess.prepare(text, **kw)
        with self._lock:
            rid = self._sess.enqueue(req)
            self._consumers[rid] = q
        return rid, q

    def cancel(self, rid: int) -> None:
        self._sess.cancel(rid)
        with self._lock:
            q = self._consumers.pop(rid, None)
        if q is not None:
            q.put(_DONE)

    def stats(self) -> dict:
        return self._sess.stats()

    def is_done(self, item) -> bool:
        return item is _DONE

    def close(self, drain: bool = False, timeout: float = 30.0) -> bool:
        """Stop the driver.  ``drain=True`` keeps stepping until live
        requests finish (bounded by ``timeout``); either way every
        still-attached consumer gets the done sentinel so no HTTP handler
        is left blocking on a queue that will never fill.  The drain
        decision is made by the DRIVER thread between steps — an outside
        ``busy`` poll can catch the session mid-step, when finished streams
        are already popped but their final audio is not yet pending, and
        stop with a round still in flight.

        Returns True when the shutdown was clean: the driver thread exited
        AND every consumer queue was emptied by its handler (so in-flight
        HTTP streams were fully flushed before the caller exits the
        process).  False means streams were truncated — logged, since
        handler threads are daemons and die with the process."""
        if drain:
            self._drain.set()
        self._stop.set()
        self._thread.join(timeout=timeout)
        clean = not self._thread.is_alive()
        if not clean:
            logger.warning(
                "serve driver did not drain within %.0fs; "
                "truncating live streams", timeout)
        with self._lock:
            consumers, self._consumers = self._consumers, {}
        for q in consumers.values():
            q.put(_DONE)
        # handler threads (daemons) still hold queued PCM: give them a
        # bounded window to flush to their sockets so a process exit right
        # after close() does not truncate responses mid-stream.
        deadline = time.monotonic() + min(10.0, timeout)
        while time.monotonic() < deadline:
            if all(q.empty() for q in consumers.values()):
                time.sleep(0.05)  # tail write (chunk terminator) grace
                return clean
            time.sleep(0.02)
        logger.warning("consumer queues still non-empty at close timeout; "
                       "some HTTP streams may be truncated")
        return False

    # -- driver thread -------------------------------------------------------

    def _drive(self) -> None:
        while True:
            if self._stop.is_set() and not (
                self._drain.is_set() and self._sess.busy
            ):
                break
            try:
                if not self._sess.busy:
                    if self._stop.is_set():
                        break  # drained
                    time.sleep(self._idle)
                    continue
                events = self._sess.step()
            except Exception:
                logger.exception("serve driver: step failed; "
                                 "failing all live streams")
                # swap + reset under ONE lock hold: a submit that slipped
                # between them would register its consumer in the fresh
                # dict while reset() silently dropped its request from the
                # session — the handler would block on q.get() forever.
                # Holding the routing lock, a submit lands either before
                # the swap (gets _DONE below) or after the rebuilt session
                # is ready to serve it.
                with self._lock:
                    consumers, self._consumers = self._consumers, {}
                    try:
                        # a failure mid-round can leave the pool's state
                        # half written: rebuild it, or every later step
                        # could fail too
                        self._sess.reset()
                    except Exception:
                        logger.exception(
                            "serve driver: session reset failed; "
                            "will retry after next step failure")
                for q in consumers.values():
                    q.put(_DONE)
                time.sleep(0.5)
                continue
            for ev in events:
                with self._lock:
                    q = self._consumers.get(ev.request_id)
                if q is None:
                    continue  # cancelled (or consumer gone)
                if ev.pcm:
                    if q.qsize() >= self._qsize:
                        # slow-consumer eviction: never block the SHARED
                        # driver thread on one stalled reader — cancel the
                        # request instead (queues are unbounded, so the
                        # sentinel put cannot block either)
                        logger.warning("request %d: consumer too slow "
                                       "(%d chunks buffered); cancelling",
                                       ev.request_id, q.qsize())
                        self.cancel(ev.request_id)
                        continue
                    q.put(ev.pcm)
                if ev.done:
                    q.put(_DONE)
                    with self._lock:
                        self._consumers.pop(ev.request_id, None)


def _make_handler(driver: ServeDriver, sample_rate: int,
                  voices: dict | None = None, encode_reference=None):
    voices = voices or {}
    # PUT /voices mutates the dict from one handler thread while GET /voices
    # (or an unknown-voice error) iterates it from another — snapshot under a
    # lock rather than lean on CPython iteration atomicity
    voices_lock = threading.Lock()

    def voice_names() -> list:
        with voices_lock:
            return sorted(voices)

    def voice_get(name):
        with voices_lock:
            return voices.get(name)

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        # quiet per-request stderr lines; route through logging instead
        def log_message(self, fmt, *args):  # noqa: D401
            logger.debug("%s - %s", self.address_string(), fmt % args)

        def _json(self, code: int, obj: dict,
                  headers: dict | None = None) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _error(self, code: int, msg: str,
                   headers: dict | None = None, **extra) -> None:
            """Error response in the endpoint's native shape: OpenAI
            clients expect the ``{"error": {"message", "type"}}`` envelope
            on ``/v1/`` paths; the native endpoints use a flat string."""
            if self.path.startswith("/v1/"):
                obj = {"error": {
                    "message": msg,
                    "type": ("invalid_request_error" if code < 500
                             else "server_error"),
                    **extra,
                }}
            else:
                obj = {"error": msg, **extra}
            self._json(code, obj, headers=headers)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(HTTPStatus.OK, {"ok": True})
            elif self.path == "/stats":
                self._json(HTTPStatus.OK, driver.stats())
            elif self.path == "/metrics":
                # Prometheus text exposition of the scheduler stats
                lines = []
                for k, v in sorted(driver.stats().items()):
                    if isinstance(v, bool) or not isinstance(v, (int, float)):
                        continue
                    name = f"fish_tts_{k}"
                    lines.append(f"# TYPE {name} gauge")
                    lines.append(f"{name} {v}")
                body = ("\n".join(lines) + "\n").encode()
                self.send_response(HTTPStatus.OK)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/voices":
                self._json(HTTPStatus.OK, {"voices": voice_names()})
            else:
                self._json(HTTPStatus.NOT_FOUND, {"error": "not found"})

        def _read_body(self) -> bytes:
            """The whole request body, read before any answer: a body left
            unread on a kept-alive connection would be parsed as the next
            request."""
            return self.rfile.read(int(self.headers.get("Content-Length", 0)))

        def do_PUT(self):
            try:
                raw = self._read_body()
            except ValueError as e:
                self._json(HTTPStatus.BAD_REQUEST, {"error": f"bad body: {e!r}"})
                return
            if not self.path.startswith("/voices/"):
                self._json(HTTPStatus.NOT_FOUND, {"error": "not found"})
                return
            if encode_reference is None:
                self._json(HTTPStatus.NOT_IMPLEMENTED,
                           {"error": "no reference encoder available"})
                return
            name = self.path.rsplit("/", 1)[1]
            if not name:
                self._json(HTTPStatus.BAD_REQUEST, {"error": "empty name"})
                return
            try:
                import base64

                req = json.loads(raw or b"{}")
                if not isinstance(req, dict):
                    raise ValueError("body must be a JSON object")
                wav = base64.b64decode(req["wav_b64"])
                text = str(req.get("text", ""))
            except (ValueError, KeyError, TypeError) as e:
                self._json(HTTPStatus.BAD_REQUEST,
                           {"error": f"bad body: {e!r}"})
                return
            try:
                profile = encode_reference(wav, text)
            except Exception as e:  # noqa: BLE001 — surface as a 400
                self._json(HTTPStatus.BAD_REQUEST,
                           {"error": f"encode failed: {e}"})
                return
            with voices_lock:
                voices[name] = profile
            self._json(HTTPStatus.OK,
                       {"voice": name, "frames": int(profile.codes.shape[1])})

        def do_DELETE(self):
            if self.path.startswith("/requests/"):
                try:
                    rid = int(self.path.rsplit("/", 1)[1])
                except ValueError:
                    self._json(HTTPStatus.BAD_REQUEST,
                               {"error": "bad request id"})
                    return
                driver.cancel(rid)
                self._json(HTTPStatus.OK, {"cancelled": rid})
            else:
                self._json(HTTPStatus.NOT_FOUND, {"error": "not found"})

        def _openai_to_native(self, req: dict) -> dict:
            """Translate an OpenAI ``/v1/audio/speech`` body to the native
            ``/synthesize`` shape.  Raises ``ValueError`` on bodies we can
            honor only by changing semantics (compressed formats, speed)."""
            if "input" not in req:
                raise ValueError("missing required field 'input'")
            fmt = req.get("response_format", "wav")
            if fmt not in ("wav", "pcm"):
                raise ValueError(
                    f"response_format {fmt!r} not supported (no audio "
                    "codec dependency); use 'wav' or 'pcm'")
            if float(req.get("speed", 1.0)) != 1.0:
                raise ValueError("speed != 1.0 is not supported")
            if req.get("stream_format", "audio") != "audio":
                raise ValueError("only stream_format 'audio' is supported")
            native = {"text": str(req["input"]), "format": fmt,
                      # wav -> buffered complete file (OpenAI semantics);
                      # pcm -> chunked stream as the pool decodes
                      "stream": fmt == "pcm"}
            # stock OpenAI voice names fall back to the default voice
            if voice_get(req.get("voice")) is not None:
                native["voice"] = req["voice"]
            for k in ("max_new_tokens", "temperature", "top_p",
                      "repetition_penalty", "seed", "priority",
                      "timeout_s"):
                if k in req:
                    native[k] = req[k]
            return native

        def do_POST(self):
            try:
                raw = self._read_body()
            except ValueError as e:
                self._error(HTTPStatus.BAD_REQUEST, f"bad body: {e!r}")
                return
            if self.path not in ("/synthesize", "/v1/audio/speech"):
                self._json(HTTPStatus.NOT_FOUND, {"error": "not found"})
                return
            try:
                req = json.loads(raw or b"{}")
                if not isinstance(req, dict):
                    raise ValueError("body must be a JSON object")
                if self.path == "/v1/audio/speech":
                    req = self._openai_to_native(req)
                text = req["text"]
            except (ValueError, KeyError, TypeError) as e:
                self._error(HTTPStatus.BAD_REQUEST, f"bad body: {e!r}")
                return
            kw = {}
            for k in ("max_new_tokens", "temperature", "top_p",
                      "repetition_penalty", "seed", "priority",
                      "timeout_s", "long", "max_chars", "carry_frames"):
                if k in req:
                    kw[k] = req[k]
            if "voice" in req:
                profile = voice_get(req["voice"])
                if profile is None:
                    self._error(HTTPStatus.BAD_REQUEST,
                                f"unknown voice {req['voice']!r}",
                                voices=voice_names())
                    return
                kw["references"] = [profile]
            fmt = req.get("format", "pcm")
            if fmt not in ("pcm", "wav"):
                self._error(HTTPStatus.BAD_REQUEST,
                            f"unknown format {fmt!r}")
                return
            try:
                rid, q = driver.submit(text, **kw)
            except QueueFull as e:
                self._error(HTTPStatus.SERVICE_UNAVAILABLE, str(e),
                            headers={"Retry-After": "1"})
                return
            except (AssertionError, ValueError, TypeError) as e:
                self._error(HTTPStatus.BAD_REQUEST, str(e))
                return
            if not req.get("stream", True):
                # buffered mode: one complete response with a known length
                # (a finished WAV with real RIFF sizes when format=wav)
                chunks = []
                while True:
                    item = q.get()
                    if driver.is_done(item):
                        break
                    chunks.append(item)
                pcm = b"".join(chunks)
                if not pcm:
                    # the request ended without producing audio (deadline
                    # expiry, cancellation, or a driver failure).  Headers
                    # have not been sent yet in buffered mode, so surface a
                    # real error instead of a 200 with an empty file.
                    self._error(HTTPStatus.GATEWAY_TIMEOUT,
                                "request ended before producing audio "
                                "(expired, cancelled, or failed)")
                    return
                if fmt == "wav":
                    body = wav_header(sample_rate, len(pcm)) + pcm
                    ctype = "audio/wav"
                else:
                    body, ctype = pcm, "audio/L16"
                self.send_response(HTTPStatus.OK)
                self.send_header("Content-Type", ctype)
                self.send_header("X-Sample-Rate", str(sample_rate))
                self.send_header("X-Request-Id", str(rid))
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            self.send_response(HTTPStatus.OK)
            self.send_header(
                "Content-Type", "audio/wav" if fmt == "wav" else "audio/L16")
            self.send_header("X-Sample-Rate", str(sample_rate))
            self.send_header("X-Request-Id", str(rid))
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            try:
                if fmt == "wav":
                    hdr = streaming_wav_header(sample_rate)
                    self.wfile.write(b"%x\r\n%s\r\n" % (len(hdr), hdr))
                while True:
                    item = q.get()
                    if driver.is_done(item):
                        break
                    self.wfile.write(b"%x\r\n%s\r\n" % (len(item), item))
                self.wfile.write(b"0\r\n\r\n")
            except (BrokenPipeError, ConnectionResetError):
                driver.cancel(rid)  # client hung up: stop decoding for it

    return Handler


def make_server(tts, host: str = "127.0.0.1", port: int = 8080,
                slots: int = 8, max_queue: int = 64,
                vocoder_device=None,
                voices: dict | None = None,
                ) -> tuple[ThreadingHTTPServer, ServeDriver]:
    """Build (server, driver) over ``tts.serve(...)``.  The caller runs
    ``server.serve_forever()`` (blocking) or in a thread, and should
    ``driver.close(); server.shutdown()`` to stop.  ``voices`` maps names to
    :class:`VoiceProfile` objects for per-request voice cloning;
    ``vocoder_device`` goes to ``tts.serve`` (the pool codec's device)."""
    sess = tts.serve(slots=slots, vocoder_device=vocoder_device,
                     max_queue=max_queue)
    driver = ServeDriver(sess)
    handler = _make_handler(driver, tts._vocoder_cfg.sample_rate,
                            voices=voices,
                            encode_reference=getattr(tts, "encode_reference", None))
    srv = ThreadingHTTPServer((host, port), handler)
    return srv, driver
