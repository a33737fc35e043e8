"""Audio serving in the port at tiny size on the CPU: ``FishTTS.serve``
(``ServeSession`` with its long-form chains and pool codec), the port's
``split_text`` against the JAX package's, and the port's HTTP server
(``serving/http.py``) on loopback sockets, with the endpoints of the JAX
package's ``tests/test_http_serving.py``.

Tolerances: served codes equal the solo run's with the same seed; PCM
within one int16 step of the joint decode of the same codes, and of the JAX
package's ``ServeSession`` fed the same codes; HTTP PCM equal to a direct
session's.  ``PUT /voices`` answers 501 from a handler built without an
encoder (``tests/test_torch_encoder.py`` registers voices through one).
"""

import base64
import http.client
import json
import re
import struct
import threading
import time

import numpy as np
import pytest
import torch
from test_torch_stream import loud_vocoder
from test_torch_stream import one_thread  # noqa: F401 (an autouse fixture)

from fish_tts_tpu.engine import serve as jserve
from fish_tts_tpu.testing import make_tiny_tts as make_jax_tts
from fish_tts_tpu.utils.text import split_text as jax_split_text
from fish_tts_tpu_torch import FishTTS, VoiceProfile, synthesizer, testing
from fish_tts_tpu_torch.engine import serve as tserve
from fish_tts_tpu_torch.serving.http import ServeDriver, _make_handler, make_server
from fish_tts_tpu_torch.synthesizer import AudioEvent, _LongChain
from fish_tts_tpu_torch.utils.audio import to_wav_bytes
from fish_tts_tpu_torch.utils.text import split_text

LONG_TEXT = "One two. Three four! Five six? Seven."


def make_tts(seed: int = 0) -> FishTTS:
    """The tiny FishTTS on the CPU, its codec jittered to give audible PCM."""
    cfg, params, tok, vcfg, _ = testing.make_tiny_bundle(seed)
    return FishTTS(device="cpu", precision="fp32", warmup=False,
                   _testing_bundle=(cfg, params, tok, vcfg, loud_vocoder()[0]))


@pytest.fixture(scope="module")
def tts():
    return make_tts()


def solo_codes(tts, text, seed, max_new):
    tts.engine.reseed(seed)
    return np.concatenate([r.codes for r in tts.engine.generate_long(
        text, max_new_tokens=max_new, streaming=True, temperature=0.7, top_p=0.8,
        repetition_penalty=1.1) if r.action == "sample"], axis=1)


def lm_codes(sess) -> dict[int, list[np.ndarray]]:
    """Records the codes of every LM event the session's batcher yields."""
    seen: dict[int, list[np.ndarray]] = {}
    step = sess._srv.step

    def spy():
        events = step()
        for ev in events:
            seen.setdefault(ev.request_id, []).append(ev.codes)
        return events

    sess._srv.step = spy
    return seen


def pcm_of(events) -> tuple[dict[int, bytes], dict[int, int], set[int]]:
    pcm, frames, done = {}, {}, set()
    for ev in events:
        pcm[ev.request_id] = pcm.get(ev.request_id, b"") + ev.pcm
        frames[ev.request_id] = ev.frames_total
        if ev.done:
            done.add(ev.request_id)
    return pcm, frames, done


def int16(b: bytes) -> np.ndarray:
    return np.frombuffer(b, np.int16).astype(np.int32)


# --- split_text --------------------------------------------------------------------

SPLIT_CASES = [
    ("First sentence here. Second one follows!  A third, with a clause; and more?  Final "
     "bit without terminal punctuation", n) for n in (12, 40, 200)
] + [("One. Two. Three.", 8), ("One. Two. Three.", 80), ("你好世界。第二句！\n\n第三句？", 6),
     ("A very long sentence that goes on, and on; with clauses: many of them, really", 20),
     ("x" * 50, 16), ("", 100), ("   \n  ", 100), (LONG_TEXT, 12)]


@pytest.mark.parametrize("text,max_chars", SPLIT_CASES)
def test_split_text_matches_jax(text, max_chars):
    assert split_text(text, max_chars) == jax_split_text(text, max_chars)
    chunks = split_text(text, max_chars)
    assert all(len(c) <= max_chars and c == c.strip() and c for c in chunks)
    assert re.sub(r"\s+", "", "".join(chunks)) == re.sub(r"\s+", "", text)


def test_split_text_rejects_zero():
    with pytest.raises(ValueError):
        split_text("hi", 0)


# --- ServeSession ------------------------------------------------------------------


def test_serve_session_audio(tts):
    """Staggered requests, the last joining a running pool: each request's
    codes are its solo run's, its PCM has frames_total x frame_length
    samples and equals the joint decode of its codes within one int16 step;
    a second session gives the same bytes."""
    fl = tts._vocoder_cfg.frame_length
    plan = [("serve req 0", 44, 60), ("serve req 1", 39, 61), ("late audio joiner", 11, 77)]

    def drive():
        sess = tts.serve(slots=2)
        codes = lm_codes(sess)
        rids = [sess.submit(t, max_new_tokens=m, seed=s) for t, m, s in plan[:2]]
        events = sess.step() + sess.step()
        rids.append(sess.submit(plan[2][0], max_new_tokens=plan[2][1], seed=plan[2][2]))
        events += list(sess.run())
        pcm, frames, done = pcm_of(events)
        assert set(rids) == done and not sess.busy
        return [pcm[r] for r in rids], [frames[r] for r in rids], \
            [np.concatenate(codes[r], axis=1) for r in rids]

    pcm, frames, codes = drive()
    for (text, m, seed), p, n, c in zip(plan, pcm, frames, codes):
        np.testing.assert_array_equal(c, solo_codes(tts, text, seed, m))
        assert len(p) // 2 == n * fl == c.shape[1] * fl > 0
        joint = int16(tts._decode_to_pcm(c))
        assert np.abs(int16(p) - joint).max() <= 1 and np.abs(joint).max() > 0
    assert drive()[0] == pcm


def test_serve_session_cancel(tts):
    """A cancelled request gets no event after its cancel and never a done;
    the co-tenant's and the successor's audio are an undisturbed session's,
    and what the cancelled one got is a prefix of its full stream."""
    def drive(do_cancel):
        sess = tts.serve(slots=1)
        r_keep = sess.submit("kept request", max_new_tokens=28, seed=91)
        events = list(sess.run())
        r_gone = sess.submit("cancel me", max_new_tokens=40, seed=92)
        r_next = sess.submit("successor", max_new_tokens=9, seed=93)
        cancelled = not do_cancel
        while sess.busy:
            for ev in sess.step():
                assert not (do_cancel and cancelled and ev.request_id == r_gone)
                events.append(ev)
                if not cancelled and ev.request_id == r_gone and ev.pcm:
                    sess.cancel(r_gone)
                    cancelled = True
        pcm, _, done = pcm_of(events)
        return (r_keep, r_gone, r_next), pcm, done

    (k1, g1, n1), pcm1, done1 = drive(True)
    assert g1 not in done1 and {k1, n1} <= done1
    (k2, g2, n2), pcm2, done2 = drive(False)
    assert {k2, g2, n2} <= done2
    assert pcm1[k1] == pcm2[k2] and pcm1[n1] == pcm2[n2]
    assert pcm2[g2].startswith(pcm1.get(g1, b"")) and len(pcm1.get(g1, b"")) < len(pcm2[g2])


def test_serve_requires_vocoder_and_one_card():
    cfg, params, tok, vcfg, _ = testing.make_tiny_bundle(0)
    bare = FishTTS(device="cpu", precision="fp32", warmup=False,
                   _testing_bundle=(cfg, params, tok, vcfg, None))
    with pytest.raises(RuntimeError, match="vocoder"):
        bare.serve()
    tts = make_tts()
    sess = tts.serve(vocoder_device="cpu", warmup=False)
    assert sess._vdev == torch.device("cpu") and sess._vstream is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tts.serve(vocoder_device="cuda:1")


def test_serve_warmup_leaks_no_events(tts):
    sess = tts.serve(slots=1, warmup=True)
    # the warm-up request ran, and stats() forgets it
    assert not sess.busy and sess.stats()["completed"] == 0
    rid = sess.submit("after warmup", max_new_tokens=4, seed=5)
    events = list(sess.run())
    assert {ev.request_id for ev in events} == {rid} and rid > 0
    assert sum(len(ev.pcm) for ev in events) > 0
    assert sess.stats()["completed"] == 1


def test_serve_follows_the_instance_warmup(monkeypatch):
    calls = []
    monkeypatch.setattr(synthesizer.ServeSession, "warmup", lambda self: calls.append(self))
    tts = make_tts()
    tts._is_warmed_up = True
    tts.serve(slots=1)
    tts.serve(slots=1, warmup=False)
    assert len(calls) == 1


def test_pool_pcm_matches_the_jax_session():
    """The port's and the JAX package's ``ServeSession`` fed the same LM
    events (two streams, staggered, a short final flush each): the same
    audio events, PCM within one int16 step."""
    jtts, ttts = make_jax_tts(), make_tts()
    jtts._vocoder_params = loud_vocoder()[1]
    vcfg = ttts._vocoder_cfg
    K = vcfg.num_codebooks
    rng = np.random.RandomState(4)

    def codes(m):
        return rng.randint(0, vcfg.residual_codebook_size, (K, m)).astype(np.int64)

    # (request, frames, done) per round; frames_total accumulates
    plan = [[(0, 8, False)], [(0, 12, False), (1, 5, False)],
            [(0, 26, True), (1, 20, False)], [], [(1, 3, True)], [], [], []]
    script = [[(r, codes(m), d) for r, m, d in rnd] for rnd in plan]

    def drive(sess, event_cls):
        totals, rounds = {}, iter(script)

        def step():
            out = []
            for r, c, d in next(rounds, []):
                totals[r] = totals.get(r, 0) + c.shape[1]
                out.append(event_cls(r, c, d, totals[r], r))
            return out

        sess._srv.step = step
        return [ev for _ in range(len(script) + 2) for ev in sess.step()]

    want = drive(jtts.serve(slots=2), jserve.Event)
    got = drive(ttts.serve(slots=2), tserve.Event)
    assert [(e.request_id, e.done, e.frames_total, len(e.pcm)) for e in got] == \
        [(e.request_id, e.done, e.frames_total, len(e.pcm)) for e in want]
    assert max(np.abs(int16(e.pcm)).max(initial=0) for e in got) > 300
    for g, w in zip(got, want):
        assert np.abs(int16(g.pcm) - int16(w.pcm)).max(initial=0) <= 1


# --- long requests -----------------------------------------------------------------


def test_serve_long_request_chains(tts):
    """A long request decodes as a chain of pool segments under one id:
    PCM across segments, one final done event, frames_total cumulative."""
    sess = tts.serve(slots=2)
    prepares = []
    real = sess._srv.prepare

    def spy(text, **kw):
        prepares.append((text, kw.get("seed"), list(kw.get("prompt_text") or [])))
        return real(text, **kw)

    sess._srv.prepare = spy
    rid = sess.submit(LONG_TEXT, long=True, max_chars=12, carry_frames=4, max_new_tokens=6,
                      seed=9)
    other = sess.submit("co tenant", max_new_tokens=6, seed=10)
    events = list(sess.run())
    assert {ev.request_id for ev in events} == {rid, other}
    mine = [ev for ev in events if ev.request_id == rid]
    assert sum(ev.done for ev in mine) == 1 and mine[-1].done
    chunks = split_text(LONG_TEXT, 12)
    segs = [p for p in prepares if p[0] in chunks]
    assert [p[0] for p in segs] == chunks and [p[1] for p in segs] == \
        [9 + i for i in range(len(chunks))]
    assert segs[1][2] == [chunks[0]]  # the carry pair: the previous chunk's text
    assert mine[-1].frames_total == sum(len(ev.pcm) for ev in mine) // 2 // \
        tts._vocoder_cfg.frame_length >= len(chunks)
    assert not sess.busy and not sess._chains and not sess._alias


def test_serve_long_cancel_mid_chain(tts):
    sess = tts.serve(slots=1)
    rid = sess.submit(LONG_TEXT, long=True, max_chars=12, carry_frames=4, max_new_tokens=6,
                      seed=11)
    got_pcm = False
    for ev in sess.run():
        if ev.request_id == rid and ev.pcm:
            got_pcm = True
            sess.cancel(rid)
            break
    tail = list(sess.run())
    assert got_pcm and all(ev.request_id != rid for ev in tail)
    assert not sess.busy and not sess._chains and not sess._alias


def test_serve_long_expiry_while_queued(tts):
    sess = tts.serve(slots=1)
    blocker = sess.submit("holds the only slot", max_new_tokens=20, seed=12)
    rid = sess.submit(LONG_TEXT, long=True, max_chars=12, carry_frames=4, max_new_tokens=6,
                      timeout_s=0.05, priority=-1)
    time.sleep(0.1)
    events = list(sess.run())
    mine = [ev for ev in events if ev.request_id == rid]
    assert mine and mine[-1].done and all(not ev.pcm for ev in mine)
    assert any(ev.request_id == blocker and ev.done for ev in events)
    assert not sess._chains and not sess._alias


def test_serve_long_chain_retries_on_queue_full(tts):
    """Backpressure at a segment boundary keeps the chain: its successor is
    retried on later rounds and every chunk still decodes."""
    sess = tts.serve(slots=1)
    rid = sess.submit(LONG_TEXT, long=True, max_chars=12, carry_frames=4, max_new_tokens=6,
                      seed=21)
    sess._srv.max_queue = -1  # every enqueue raises QueueFull until lifted
    events, retry_rounds = [], 0
    try:
        while sess.busy:
            if sess._chain_retry:
                retry_rounds += 1
            if retry_rounds >= 3:
                sess._srv.max_queue = 0
            events.extend(sess.step())
    finally:
        sess._srv.max_queue = 0
    assert retry_rounds >= 3
    mine = [ev for ev in events if ev.request_id == rid]
    assert sum(ev.done for ev in mine) == 1 and mine[-1].done
    assert mine[-1].frames_total >= len(split_text(LONG_TEXT, 12)) >= 2
    assert not sess.busy and not sess._chains and not sess._chain_retry


def test_serve_long_chain_does_not_pin_other_streams(tts, monkeypatch):
    """A co-tenant arriving mid-chain takes another codec lane and finishes
    before the chain."""
    sess = tts.serve(slots=2)
    created, picked = [], []
    orig_init = synthesizer._SlotAudioStream.__init__

    def init_spy(self, rid):
        created.append(rid)
        orig_init(self, rid)

    monkeypatch.setattr(synthesizer._SlotAudioStream, "__init__", init_spy)
    orig_pick = sess._pick_lane
    sess._pick_lane = lambda: picked.append(orig_pick()) or picked[-1]
    rid = sess.submit("One two. Three four! Five six? Seven eight. Nine ten. Eleven twelve!",
                      long=True, max_chars=10, carry_frames=4, max_new_tokens=5, seed=31)
    co, events = None, []
    while sess.busy:
        events.extend(sess.step())
        with sess._cancel_lock:
            chain = sess._chains.get(rid)
        if co is None and chain is not None and chain.idx >= 2:
            co = sess.submit("quick co tenant", max_new_tokens=4, seed=33)
    assert co is not None
    lanes = dict(zip(created, picked))
    assert lanes[co] != lanes[rid]
    order = [ev.request_id for ev in events if ev.done]
    assert order.index(co) < order.index(rid)


def test_take_carry_zero_frames_returns_none():
    chain = _LongChain(["a", "b"], [], [], 0, {}, None, 0.0)
    chain.feed(np.ones((4, 3), np.int32))
    assert chain.take_carry() is None and chain.tail is None
    chain = _LongChain(["a", "b"], [], [], 2, {}, None, 0.0)
    chain.feed(np.arange(12).reshape(4, 3))
    assert chain.take_carry().tolist() == [[0, 1], [3, 4], [6, 7], [9, 10]]


def test_chain_keeps_base_refs_when_segment_has_no_carry(tts):
    sess = tts.serve(slots=1)
    base = [np.zeros((tts._cfg.num_codebooks, 2), np.int64)]
    chain = _LongChain(["seg a.", "seg b."], ["r"], base, 4, {"max_new_tokens": 4}, None, 0.0)
    seen = {}

    def prepare_spy(text, **kw):
        seen["text"], seen["kw"] = text, kw
        raise ValueError("stop before touching scheduler state")

    sess._srv.prepare = prepare_spy
    assert sess._chain_next(77, chain) == "end"
    assert seen["text"] == "seg b." and seen["kw"]["prompt_text"] == ["r"]
    assert [c.shape for c in seen["kw"]["prompt_tokens"]] == [(4, 2)]


# --- the HTTP server -----------------------------------------------------------------


@pytest.fixture(scope="module")
def server(tts):
    gura = VoiceProfile(codes=np.random.RandomState(0).randint(
        0, 24, (tts._cfg.num_codebooks, 6)).astype(np.int64),
        text="tiny reference transcript", name="gura")
    srv, driver = make_server(tts, host="127.0.0.1", port=0, slots=2, max_queue=8,
                              voices={"gura": gura})
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv.server_address, tts
    driver.close()
    srv.shutdown()


def post(addr, body, path="/synthesize", timeout=120):
    conn = http.client.HTTPConnection(*addr, timeout=timeout)
    conn.request("POST", path, body if isinstance(body, str) else json.dumps(body),
                 {"Content-Type": "application/json"})
    return conn


def fetch(addr, body, path="/synthesize"):
    conn = post(addr, body, path)
    r = conn.getresponse()
    out = r.status, dict(r.headers), r.read()
    conn.close()
    return out


def direct_pcm(tts, text, seed, max_new, slots=2):
    sess = tts.serve(slots=slots)
    rid = sess.submit(text, max_new_tokens=max_new, seed=seed)
    return pcm_of(list(sess.run()))[0][rid]


def test_synthesize_streams_pcm(server):
    addr, tts = server
    status, headers, pcm = fetch(addr, {"text": "http hello", "max_new_tokens": 24, "seed": 5})
    assert status == 200 and headers["Content-Type"] == "audio/L16"
    assert int(headers["X-Sample-Rate"]) == tts._vocoder_cfg.sample_rate
    fl = tts._vocoder_cfg.frame_length
    assert len(pcm) > 0 and len(pcm) % (2 * fl) == 0


def test_concurrent_requests_share_the_pool(server):
    """An L16 and a WAV request in flight at once: both stream to the end,
    each equal to a direct ServeSession run with the same seed."""
    addr, tts = server
    want = {i: direct_pcm(tts, f"concurrent {i}", 40 + i, 20 + 4 * i) for i in range(2)}
    got = {}

    def run(i):
        body = {"text": f"concurrent {i}", "seed": 40 + i, "max_new_tokens": 20 + 4 * i}
        got[i] = fetch(addr, dict(body, format="wav") if i else body)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert got[0][1]["Content-Type"] == "audio/L16" and got[0][2] == want[0]
    assert got[1][1]["Content-Type"] == "audio/wav" and got[1][2][44:] == want[1]


def test_stats_health_and_metrics(server):
    addr, _ = server
    conn = http.client.HTTPConnection(*addr, timeout=60)
    conn.request("GET", "/healthz")
    assert json.loads(conn.getresponse().read())["ok"] is True
    conn.request("GET", "/stats")
    st = json.loads(conn.getresponse().read())
    assert st["slots"] == 2 and "completed" in st
    conn.request("GET", "/metrics")
    r = conn.getresponse()
    assert r.status == 200 and r.headers["Content-Type"].startswith("text/plain")
    body = r.read().decode()
    conn.close()
    assert "fish_tts_queue_depth " in body and "fish_tts_live_slots " in body
    for line in body.strip().splitlines():
        if not line.startswith("#"):
            name, val = line.split(" ")
            assert name.startswith("fish_tts_")
            float(val)


def test_cancel_endpoint_ends_stream(server):
    addr, _ = server
    conn = post(addr, {"text": "cancel over http", "max_new_tokens": 600, "seed": 51})
    resp = conn.getresponse()
    rid = int(resp.headers["X-Request-Id"])
    first = resp.read(4)
    c2 = http.client.HTTPConnection(*addr, timeout=60)
    c2.request("DELETE", f"/requests/{rid}")
    assert json.loads(c2.getresponse().read())["cancelled"] == rid
    c2.close()
    rest = resp.read()
    conn.close()
    assert len(first) + len(rest) < 600 * 2 * 2048


def test_wav_format_and_buffered_mode(server):
    """format=wav streams the unknown-length RIFF header and the PCM run of
    the same seed; stream=false answers one sized WAV; mp3 is refused."""
    addr, _ = server
    body = {"text": "wav please", "max_new_tokens": 12, "seed": 13}
    status, headers, wav = fetch(addr, dict(body, format="wav"))
    assert headers["Content-Type"] == "audio/wav"
    assert wav[:4] == b"RIFF" and wav[8:12] == b"WAVE" and len(wav) > 44
    pcm = fetch(addr, body)[2]
    assert wav[44:] == pcm
    status, headers, full = fetch(addr, dict(body, stream=False, format="wav"))
    assert headers["Content-Length"] == str(len(full))
    assert struct.unpack("<I", full[4:8])[0] == len(full) - 8 and full[-len(pcm):] == pcm
    assert fetch(addr, dict(body, format="mp3"))[0] == 400


def test_per_request_voice_over_http(server):
    addr, _ = server
    body = {"text": "voice pick", "max_new_tokens": 16, "seed": 9}
    voiced = fetch(addr, dict(body, voice="gura"))[2]
    plain = fetch(addr, body)[2]
    assert len(voiced) > 0 and voiced != plain
    status, _, out = fetch(addr, dict(body, voice="nope"))
    assert status == 400 and json.loads(out)["voices"] == ["gura"]
    conn = http.client.HTTPConnection(*addr, timeout=60)
    conn.request("GET", "/voices")
    assert json.loads(conn.getresponse().read())["voices"] == ["gura"]
    conn.close()


def test_put_voice_answers_501_without_an_encoder(server):
    """A handler built with no encoder answers 501; both bodies go on one
    kept-alive connection: the first is read whole before the answer, so the
    second request parses."""
    from http.server import ThreadingHTTPServer

    _, tts = server
    sr = tts._vocoder_cfg.sample_rate
    gura = VoiceProfile(codes=np.zeros((tts._cfg.num_codebooks, 2), np.int64), name="gura")
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(
        None, sr, voices={"gura": gura}, encode_reference=None))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    wav = to_wav_bytes(np.sin(np.linspace(0, 880 * np.pi, sr)).astype(np.float32) * 0.3, sr)
    conn = http.client.HTTPConnection(*srv.server_address, timeout=60)
    try:
        for body in (json.dumps({"wav_b64": base64.b64encode(wav).decode(), "text": "a ref"}),
                     "[1]"):
            conn.request("PUT", "/voices/newvoice", body)
            r = conn.getresponse()
            assert r.status == 501 and "encoder" in json.loads(r.read())["error"]
        conn.request("GET", "/voices")
        assert json.loads(conn.getresponse().read())["voices"] == ["gura"]
    finally:
        conn.close()
        srv.shutdown()


def test_bad_body_and_unknown_path(server):
    addr, _ = server
    conn = http.client.HTTPConnection(*addr, timeout=60)
    for body in ("{}", "[1,2]", '"str"', '{"text": "x", "temperature": "hot"}',
                 '{"text": "x", "priority": "high"}', '{"text": "x", "seed": "abc"}',
                 '{"text": "x", "temperature": 3.0}'):
        conn.request("POST", "/synthesize", body, {"Content-Type": "application/json"})
        r = conn.getresponse()
        assert r.status == 400, body
        r.read()
    for method, path in (("GET", "/nope"), ("PUT", "/nope"), ("DELETE", "/nope"),
                         ("POST", "/nope")):
        # a body left unread on this kept-alive connection would be parsed
        # as the next request
        conn.request(method, path, '{"text": "x"}' if method in ("PUT", "POST") else None)
        r = conn.getresponse()
        assert r.status == 404
        r.read()
    conn.request("DELETE", "/requests/abc")
    r = conn.getresponse()
    assert r.status == 400
    r.read()
    conn.close()


def test_deadline_expiry_ends_http_stream(server):
    addr, _ = server
    status, _, pcm = fetch(addr, {"text": "expires mid-decode", "max_new_tokens": 4000,
                                  "seed": 33, "timeout_s": 0.3})
    assert status == 200 and len(pcm) < 4000 * 2 * 2048
    status, _, out = fetch(addr, {"text": "after expiry", "max_new_tokens": 8, "seed": 34})
    assert status == 200 and len(out) > 0


def test_openai_speech_endpoint(server):
    """``/v1/audio/speech``: a complete WAV with real sizes (a stock voice
    name falls back to the default voice, as a direct run of the same seed
    gives), a PCM stream with a registry voice, and 400s in OpenAI's error
    envelope for what it cannot honor."""
    addr, tts = server
    status, headers, body = fetch(addr, {"model": "tts-1", "input": "openai hello",
                                         "voice": "alloy", "seed": 7, "max_new_tokens": 16},
                                  path="/v1/audio/speech")
    assert status == 200 and headers["Content-Type"] == "audio/wav"
    assert body[:4] == b"RIFF" and struct.unpack("<I", body[4:8])[0] == len(body) - 8
    assert body[44:] == direct_pcm(tts, "openai hello", 7, 16)
    status, headers, pcm = fetch(addr, {"input": "pcm", "voice": "gura", "response_format": "pcm",
                                        "seed": 8, "max_new_tokens": 12},
                                 path="/v1/audio/speech")
    fl = tts._vocoder_cfg.frame_length
    assert status == 200 and headers["Content-Type"] == "audio/L16"
    assert len(pcm) > 0 and len(pcm) % (2 * fl) == 0
    for bad in ('{"voice": "alloy"}', '{"input": "x", "response_format": "mp3"}',
                '{"input": "x", "speed": 1.5}', '{"input": "x", "stream_format": "sse"}'):
        status, _, out = fetch(addr, bad, path="/v1/audio/speech")
        err = json.loads(out)["error"]
        assert status == 400 and err["type"] == "invalid_request_error", bad
    assert "mp3" in json.loads(fetch(addr, '{"input": "x", "response_format": "mp3"}',
                                     path="/v1/audio/speech")[2])["error"]["message"]


def test_buffered_mode_errors_on_no_audio(server):
    """A buffered request that expires while queued gets a 504."""
    addr, _ = server
    blockers = [post(addr, {"text": f"blocker {i}", "max_new_tokens": 600, "seed": 60 + i})
                for i in range(4)]
    resps = [c.getresponse() for c in blockers[:2]]
    for r in resps:
        assert len(r.read(2)) == 2
    status, _, out = fetch(addr, {"text": "expires queued", "max_new_tokens": 10,
                                  "timeout_s": 0.02, "stream": False, "format": "wav"})
    assert status == 504 and "error" in json.loads(out)
    resps += [c.getresponse() for c in blockers[2:]]
    for c, r in zip(blockers, resps):
        r.read()
        c.close()


def test_driver_close_releases_inflight_consumers(tts):
    driver = ServeDriver(tts.serve(slots=1))
    _, q = driver.submit("drain me", max_new_tokens=8, seed=21)
    driver.close(drain=True, timeout=300)
    chunks = []
    while not driver.is_done(item := q.get(timeout=10)):
        chunks.append(item)
    assert sum(len(c) for c in chunks) > 0
    driver2 = ServeDriver(tts.serve(slots=1))
    _, q2 = driver2.submit("cut short", max_new_tokens=4000, seed=22)
    driver2.close(drain=False)
    while not driver2.is_done(q2.get(timeout=10)):
        pass


def test_driver_recovery_is_atomic_with_submit():
    """A submit racing the recovery from a failed step waits until the
    session is rebuilt, then is served by it."""

    class FakeSession:
        def __init__(self):
            self.fail_next = True
            self.in_reset, self.release_reset = threading.Event(), threading.Event()
            self.epoch, self.enqueue_epoch, self.pending, self.busy = 0, {}, [], True

        def prepare(self, text, **kw):
            return text

        def enqueue(self, req):
            rid = len(self.enqueue_epoch) + 1
            self.enqueue_epoch[rid] = self.epoch
            self.pending.append(rid)
            return rid

        def step(self):
            if self.fail_next:
                self.fail_next = False
                raise RuntimeError("injected device failure")
            if self.pending:
                return [AudioEvent(self.pending.pop(0), b"\x01\x02", True, 1)]
            time.sleep(0.002)
            return []

        def reset(self):
            self.in_reset.set()
            assert self.release_reset.wait(5)
            self.epoch += 1

        def cancel(self, rid):
            pass

        def stats(self):
            return {}

    fake = FakeSession()
    drv = ServeDriver(fake, poll_idle_s=0.001)
    try:
        assert fake.in_reset.wait(5)
        result = {}
        t = threading.Thread(target=lambda: result.update(zip(("rid", "q"),
                                                              drv.submit("late request"))))
        t.start()
        time.sleep(0.3)
        assert "rid" not in result and not fake.enqueue_epoch
        fake.release_reset.set()
        t.join(timeout=5)
        assert fake.enqueue_epoch[result["rid"]] == 1
        assert result["q"].get(timeout=5) == b"\x01\x02"
        assert drv.is_done(result["q"].get(timeout=5))
    finally:
        fake.release_reset.set()
        fake.busy = False
        drv.close(timeout=5)
