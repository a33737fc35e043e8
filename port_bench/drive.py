"""How a mix's ``kind`` drives the program, and what the harness records.

- ``serve_closed``: ``FishTTS.serve(slots)``; ``outstanding`` requests are
  in the system at all times, each completion submitting the next.  The
  pool is filled in set-up, so the window opens on a busy pool.  Nothing
  is submitted after the window; the greedy requests in flight are
  followed until the finished ones hold ``SAMPLE_FRAMES`` frames.
- ``serve_open``: ``FishTTS.serve(slots)``; requests arrive at
  ``Traffic.arrival`` times from the window's start, whatever the program
  does, and are submitted before the next ``step()`` once due.  After the
  window, the requests due in it are followed until they finish (at most
  ``FOLLOW_S``).
- ``stream_closed``: one client calls ``FishTTS.synthesize_stream`` and
  reads each call to its end before the next; the call in flight when the
  window closes is read to its end, and calls go on after it (due after
  the close, so no metric counts them) until a greedy request and one that
  samples were made.

A request is due when it arrives (open loop) or when the request before it
in its client's place finished (closed loop).  The harness records, on the
host's clock: each request's due time and every PCM delivery (time and
bytes), each ``step()`` / ``next()`` as a span, and, through a tap on the
codes the LM hands the codec, each request's codes.  Set-up (the
kernels' build, the weights, the instance, the warm-up of every shape the
mix will meet) ends when the window opens.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


from port_bench.reference.prompt import prompt_length
from port_bench.traffic import Request, Traffic

FOLLOW_S = 60.0  # the longest a request due in the window is waited for after it
SAMPLE_FRAMES = 300  # frames of finished greedy requests the check wants
STREAM_FIRST, STREAM_EVERY = 10, 20  # synthesize_stream's default flushes


@dataclass
class Rec:
    """One request as the harness saw it."""

    req: Request
    due: float
    rid: int | None = None
    deliveries: list = field(default_factory=list)  # (time, pcm bytes)
    done_at: float | None = None
    failed: str | None = None
    pcm: list = field(default_factory=list)  # greedy requests only
    codes: list = field(default_factory=list)  # from the tap

    @property
    def first(self) -> float | None:
        return self.deliveries[0][0] if self.deliveries else None


class Clock:
    """The spans the harness records, on ``time.perf_counter``."""

    def __init__(self):
        self.spans: list[tuple[str, float, float]] = []

    def span(self, name: str, fn, *args, **kw):
        t = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            self.spans.append((name, t, time.perf_counter()))


class Window:
    """The measured window: opened at ``t0``, closing at ``t0 + seconds``;
    ``t1`` is the end of the last round that started before the close.
    ``tick`` is called between rounds: from ``close - tail`` on, the
    ``on_tail`` hook runs once (the traced run starts its trace there)."""

    def __init__(self, seconds: float, tail: float = 0.0, on_open=None, on_tail=None,
                 on_close=None):
        self.seconds, self.tail = seconds, tail
        self.hooks = [on_open, on_tail, on_close]
        self.t0 = self.t1 = self.close = None

    def _run(self, i: int) -> None:
        hook, self.hooks[i] = self.hooks[i], None
        if hook is not None:
            hook()

    def open(self) -> float:
        self._run(0)
        self.t0 = time.perf_counter()
        self.close = self.t0 + self.seconds
        self.tick(self.t0)
        return self.t0

    def tick(self, now: float) -> None:
        if now >= self.close - self.tail:
            self._run(1)

    def ended(self, t: float) -> None:
        self.t1 = t
        self._run(2)


def _sampling(req: Request) -> dict:
    return dict(temperature=req.sampling["temperature"], top_p=req.sampling["top_p"],
                repetition_penalty=req.sampling["repetition_penalty"])


class Serving:
    """A ``FishTTS.serve`` session with its records and the code tap."""

    def __init__(self, tts, traffic: Traffic, slots: int, clock: Clock):
        self.tts, self.traffic, self.clock = tts, traffic, clock
        self.sess = tts.serve(slots=slots, warmup=False)
        self.recs: list[Rec] = []
        self.by_rid: dict[int, Rec] = {}
        self.lm_frames: list[tuple[float, int, int]] = []  # (time, request, frames)
        self._tap()

    def _tap(self) -> None:
        """Read the codes the LM pool hands the codec each round: the
        batcher's events pass through unchanged."""
        srv = self.sess._srv
        inner = srv.step

        def step():
            events = inner()
            t = time.perf_counter()
            for ev in events:
                n = ev.codes.shape[1]
                self.lm_frames.append((t, ev.request_id, n))
                rec = self.by_rid.get(ev.request_id)
                if rec is not None and n:
                    rec.codes.append(ev.codes)
            return events

        srv.step = step

    def submit(self, req: Request, due: float) -> Rec:
        rec = Rec(req=req, due=due)
        voices = self.traffic.voice_refs(req)
        refs = None
        if voices:
            from fish_tts_tpu_torch.synthesizer import VoiceProfile

            refs = [VoiceProfile(codes=c, text=t) for t, c in voices]
        rec.rid = self.clock.span("submit", self.sess.submit, req.text,
                                  max_new_tokens=req.frames, seed=req.seed, references=refs,
                                  **_sampling(req))
        self.recs.append(rec)
        self.by_rid[rec.rid] = rec
        return rec

    def step(self) -> list[Rec]:
        """One round; returns the requests that finished in it."""
        events = self.clock.span("step", self.sess.step)
        t = time.perf_counter()
        finished = []
        for ev in events:
            rec = self.by_rid.get(ev.request_id)
            if rec is None:
                continue
            if ev.pcm:
                rec.deliveries.append((t, len(ev.pcm)))
                if rec.req.greedy:
                    rec.pcm.append(ev.pcm)
            if ev.done:
                rec.done_at = t
                finished.append(rec)
        return finished

    def drain(self) -> None:
        while self.sess.busy:
            self.step()


def warm_lengths(lo: int, hi: int, frames_hi: int, step: int, chunk: int,
                 longest: int) -> list[int]:
    """Prompt lengths whose requests reach every read window (``step``
    rows) the mix's requests reach: a prompt of ``lengths[i]`` puts the
    pool's read bound in window i within its first rounds.  No prompt is
    longer than ``longest``, the engine's limit."""
    top = hi + frames_hi + 2 * chunk
    windows = range(-(-(lo + 2 * chunk) // step), -(-top // step) + 1)
    return sorted({min(longest, max(lo, w * step - 3 * chunk)) for w in windows})


def warm_serving(srv: Serving, traffic: Traffic, engine_cfg) -> None:
    """Every prompt bucket and read window the mix meets, one request each,
    drained before the next (the pool codec's round with the first)."""
    chunk, kv_step = engine_cfg.decode_chunk, engine_cfg.kv_bucket_step
    buckets = engine_cfg.prompt_buckets
    spec = traffic.spec
    voices = list(range(len(traffic.voices))) or [None]
    req0 = traffic.request(1)
    lo, hi = spec["prompt_tokens"]
    lengths = sorted({prompt_length(n, _voice_sizes(traffic, v)) for n in (lo, hi)
                      for v in voices})
    plo, phi = lengths[0], lengths[-1]
    prompts = {plo, phi, *(b for b in buckets if plo <= b <= phi)}
    ctx = srv.tts.engine.cfg.max_seq_len
    longest = ctx - min(2048, ctx // 2)  # the engine keeps half the context for output
    for n in sorted(prompts | set(warm_lengths(plo, phi, spec["frames"][1], kv_step, chunk,
                                               longest))):
        vidx, text_n = _fit(traffic, n)
        req = Request(index=-1, text="w" * text_n, frames=2 * chunk, sampling=req0.sampling,
                      greedy=False, voice=vidx, seed=None)
        srv.submit(req, time.perf_counter())
        srv.drain()
    srv.recs.clear()
    srv.by_rid.clear()
    srv.lm_frames.clear()


def _voice_sizes(traffic: Traffic, v) -> list[tuple[int, int]]:
    if v is None:
        return []
    text, codes = traffic.voices[v]
    return [(len(text), codes.shape[1])]


def _fit(traffic: Traffic, n: int) -> tuple[int | None, int]:
    """A voice and a text length whose prompt is ``n`` tokens (the longest
    voice that leaves text)."""
    best = (None, max(1, n - prompt_length(0)))
    for v in range(len(traffic.voices)):
        rest = n - prompt_length(0, _voice_sizes(traffic, v))
        if rest >= 1:
            best = (v, rest)
    return best


def serve_closed(tts, traffic: Traffic, window: Window, clock: Clock, engine_cfg) -> dict:
    spec = traffic.spec
    srv = Serving(tts, traffic, spec["slots"], clock)
    warm_serving(srv, traffic, engine_cfg)
    nxt = 0
    for _ in range(spec["outstanding"]):
        srv.submit(traffic.request(nxt), time.perf_counter())
        nxt += 1
    while sum(1 for r in srv.recs if r.deliveries) < spec["slots"]:
        srv.step()
    t = window.open()
    while t < window.close:
        for _ in srv.step():
            if time.perf_counter() < window.close:
                srv.submit(traffic.request(nxt), time.perf_counter())
                nxt += 1
        t = time.perf_counter()
        window.tick(t)
    window.ended(t)
    follow_greedy(srv, t + FOLLOW_S)
    return {"recs": srv.recs, "lm_frames": srv.lm_frames, "sess": srv.sess}


def follow_greedy(srv: Serving, deadline: float) -> None:
    """After the window, step on (submitting nothing) until the greedy
    requests finished hold ``SAMPLE_FRAMES`` frames, or none is in flight:
    the check's sample needs finished greedy requests."""
    while time.perf_counter() < deadline:
        greedy = [r for r in srv.recs if r.req.greedy]
        done = sum(r.req.frames for r in greedy if r.done_at is not None)
        if done >= SAMPLE_FRAMES or all(r.done_at is not None for r in greedy):
            return
        srv.step()


def serve_open(tts, traffic: Traffic, window: Window, clock: Clock, engine_cfg) -> dict:
    spec = traffic.spec
    srv = Serving(tts, traffic, spec["slots"], clock)
    warm_serving(srv, traffic, engine_cfg)
    t0 = window.open()
    nxt, due = 0, t0 + traffic.arrival(0)
    closed = False
    while True:
        now = time.perf_counter()
        window.tick(now)
        while due < window.close and due <= now:
            srv.submit(traffic.request(nxt), due)
            nxt += 1
            due = t0 + traffic.arrival(nxt)
        if not closed and now >= window.close:
            window.ended(now)
            closed = True
        if closed:
            if all(r.done_at is not None for r in srv.recs) or now > window.close + FOLLOW_S:
                break
        if srv.sess.busy:
            srv.step()
        elif not closed:
            time.sleep(max(0.0, min(due, window.close) - now))
        else:
            break
    for r in srv.recs:
        if r.done_at is None and r.failed is None:
            r.failed = "not finished a minute after the window"
    return {"recs": srv.recs, "lm_frames": srv.lm_frames, "sess": srv.sess}


def stream_closed(tts, traffic: Traffic, window: Window, clock: Clock, engine_cfg) -> dict:
    spec = traffic.spec
    recs: list[Rec] = []
    lm_frames: list[tuple[float, int, int]] = []  # (time, request, frames)
    current: list[Rec] = []
    eng = tts.engine
    inner = eng.generate_long

    def tap(*args, **kw):
        """The engine's codes for the call in flight pass through unchanged."""
        for resp in inner(*args, **kw):
            if resp.codes is not None and resp.codes.shape[1]:
                lm_frames.append((time.perf_counter(), current[0].rid,
                                  resp.codes.shape[1]))
                if current:
                    current[0].codes.append(resp.codes)
            yield resp

    eng.generate_long = tap

    def call(req: Request, due: float) -> Rec:
        rec = Rec(req=req, due=due, rid=req.index)
        current[:] = [rec]
        if req.seed is not None:  # the call samples what a request with this seed would
            eng.reseed(req.seed)
        it = clock.span("submit", tts.synthesize_stream, req.text, max_tokens=req.frames,
                        **_sampling(req))
        while True:
            try:
                pcm = clock.span("stream_next", next, it)
            except StopIteration:
                break
            rec.deliveries.append((time.perf_counter(), len(pcm)))
            if req.greedy:
                rec.pcm.append(pcm)
        rec.done_at = time.perf_counter()
        return rec

    # warm-up: every prompt bucket at the longest output, then every size
    # of a final codec chunk
    lo, hi = spec["prompt_tokens"]
    flo, fhi = spec["frames"]
    sizes = sorted({(f - STREAM_FIRST - 1) % STREAM_EVERY + 1 for f in range(flo, fhi + 1)})
    warm = [(n, fhi) for n in sorted({lo, hi, *_bucket_edges(lo, hi, engine_cfg)})]
    warm += [(lo, STREAM_FIRST + s) for s in sizes]
    for n, f in warm:
        call(Request(-1, "w" * n, f, traffic.request(1).sampling, False, None, None), 0.0)
    lm_frames.clear()
    window.open()
    i = 0
    while True:
        now = time.perf_counter()
        window.tick(now)
        if now >= window.close:
            window.ended(now)
            break
        recs.append(call(traffic.request(i), now))
        i += 1
    # the check wants a greedy request and one that samples
    while (len({r.req.greedy for r in recs}) < 2
           and time.perf_counter() < window.close + FOLLOW_S):
        recs.append(call(traffic.request(i), time.perf_counter()))
        i += 1
    return {"recs": recs, "lm_frames": lm_frames, "sess": None}


def _bucket_edges(lo: int, hi: int, engine_cfg) -> list[int]:
    """Text lengths in [lo, hi] whose prompts are each prompt bucket's
    longest."""
    out = []
    for b in engine_cfg.prompt_buckets:
        n = b - prompt_length(0)
        if lo <= n <= hi:
            out.append(n)
    return out


KINDS = {"serve_closed": serve_closed, "serve_open": serve_open,
         "stream_closed": stream_closed}

