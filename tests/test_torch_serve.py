"""Continuous batching in the port (``engine/serve.py``) at tiny size on the
CPU: the invariants of the JAX package's ``tests/test_serve.py`` held on
the port's ``ContinuousBatcher``, and its events against the JAX package's
``ContinuousBatcher`` on the same weights and noise.

The load-bearing property: a request admitted into a running pool samples
the codes of its solo run with the same seed (``engine.reseed(seed)`` and a
streamed ``generate_long``), whoever its co-tenants are and whenever it was
admitted.  Those comparisons are exact.  Against JAX, the port replays each
request's draws (``fold_in(slot key, step)``); codes, done flags and
frame counts are equal, a first differing code excused only at a knife edge
of the port's own decision (``testing.sample_decision_margins``, logits
that may each move by ``LOGIT_TOL`` of their largest magnitude).
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_stream import LOGIT_TOL, Decisions
from test_torch_stream import one_thread  # noqa: F401 (an autouse fixture)

from fish_tts_tpu.config import TINY_CONFIG as J_CFG
from fish_tts_tpu.config import EngineConfig as JEngineConfig
from fish_tts_tpu.engine import decode as jdecode
from fish_tts_tpu.engine.generate import GenerationEngine as JEngine
from fish_tts_tpu.engine.serve import ContinuousBatcher as JBatcher
from fish_tts_tpu.models import dual_ar as jdual
from fish_tts_tpu.models.tokenizer import FishTokenizer as JTokenizer
from fish_tts_tpu.models.tokenizer import tiny_special_tokens, write_tiny_vocab
from fish_tts_tpu_torch import testing
from fish_tts_tpu_torch.config import TINY_CONFIG as T_CFG
from fish_tts_tpu_torch.config import EngineConfig
from fish_tts_tpu_torch.engine import decode as tdecode
from fish_tts_tpu_torch.engine import generate as tgenerate
from fish_tts_tpu_torch.engine.generate import GenerationEngine
from fish_tts_tpu_torch.engine.serve import ContinuousBatcher, QueueFull
from fish_tts_tpu_torch.models.tokenizer import FishTokenizer as TTokenizer
from fish_tts_tpu_torch.utils import checkpoint as tckpt

K = T_CFG.num_codebooks
SAMPLING = dict(temperature=0.7, top_p=0.8, repetition_penalty=1.1)


def make_engine(**ecfg) -> GenerationEngine:
    cfg, params, tok, _, _ = testing.make_tiny_bundle(0)
    ecfg = {"prompt_buckets": (32,), "decode_chunk": 8, "first_chunk": 4, **ecfg}
    return GenerationEngine(params, cfg, tok, engine_cfg=EngineConfig(**ecfg), seed=0)


@pytest.fixture(scope="module")
def engine():
    return make_engine()


def solo_codes(engine, text, seed, max_new, **kw):
    """The reference answer: a solo streamed ``generate_long`` after
    ``reseed(seed)``."""
    engine.reseed(seed)
    sampling = {**SAMPLING, **kw}
    chunks = [r.codes for r in engine.generate_long(text, max_new_tokens=max_new, streaming=True,
                                                    **sampling) if r.action == "sample"]
    return np.concatenate(chunks, axis=1)


def collect(events):
    out: dict[int, list[np.ndarray]] = {}
    done: set[int] = set()
    for ev in events:
        out.setdefault(ev.request_id, []).append(ev.codes)
        if ev.done:
            done.add(ev.request_id)
    return {k: np.concatenate(v, axis=1) for k, v in out.items()}, done


def submit(srv, text, max_new, seed, **kw):
    return srv.submit(text, max_new_tokens=max_new, seed=seed, **{**SAMPLING, **kw})


def random_ref(seed: int, n: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    codes = rng.randint(0, 24, (K, n)).astype(np.int64)
    codes[0] = rng.randint(0, 48, n)
    return codes


def test_single_request_matches_solo(engine):
    solo = solo_codes(engine, "hello pool", 5, 20)
    srv = ContinuousBatcher(engine, slots=3)
    rid = submit(srv, "hello pool", 20, 5)
    codes, done = collect(srv.run())
    assert rid in done
    np.testing.assert_array_equal(codes[rid], solo)


def test_midflight_admission_matches_solo(engine):
    """A request admitted while another slot is mid-decode samples its solo
    run's codes, and so does the co-tenant."""
    solo_a = solo_codes(engine, "first request text", 11, 30)
    solo_b = solo_codes(engine, "late joiner", 22, 18)
    srv = ContinuousBatcher(engine, slots=2)
    rid_a = submit(srv, "first request text", 30, 11)
    events = srv.step() + srv.step()
    rid_b = submit(srv, "late joiner", 18, 22)
    events += list(srv.run())
    codes, done = collect(events)
    assert {rid_a, rid_b} <= done
    np.testing.assert_array_equal(codes[rid_a], solo_a)
    np.testing.assert_array_equal(codes[rid_b], solo_b)


def test_more_requests_than_slots(engine):
    texts = [f"req number {i}" for i in range(5)]
    solos = [solo_codes(engine, t, 100 + i, 10) for i, t in enumerate(texts)]
    srv = ContinuousBatcher(engine, slots=2)
    rids = [submit(srv, t, 10, 100 + i) for i, t in enumerate(texts)]
    codes, done = collect(srv.run())
    assert set(rids) <= done
    for rid, solo in zip(rids, solos):
        np.testing.assert_array_equal(codes[rid], solo)


def test_cancel_queued_request(engine):
    solo = solo_codes(engine, "keeps running", 31, 16)
    srv = ContinuousBatcher(engine, slots=1)
    r_keep = submit(srv, "keeps running", 16, 31)
    r_gone = submit(srv, "never admitted", 16, 32)
    srv.cancel(r_gone)
    codes, done = collect(srv.run())
    assert r_gone not in codes and r_gone not in done
    np.testing.assert_array_equal(codes[r_keep], solo)


def test_cancel_running_request_frees_slot(engine):
    """A cancel mid-decode stops the request's events (what it emitted is a
    prefix of its solo run) and its slot takes the queued successor; the
    co-tenant and the successor are exact."""
    solo_a = solo_codes(engine, "long co-tenant", 41, 32)
    solo_b = solo_codes(engine, "to be cancelled", 42, 32)
    solo_c = solo_codes(engine, "successor", 43, 8)
    srv = ContinuousBatcher(engine, slots=2)
    r_a, r_b, r_c = (submit(srv, "long co-tenant", 32, 41), submit(srv, "to be cancelled", 32, 42),
                     submit(srv, "successor", 8, 43))
    events, cancelled_at, rounds = [], None, 0
    while srv.busy:
        evs = srv.step()
        rounds += 1
        if cancelled_at is not None:
            assert all(e.request_id != r_b for e in evs), "an event after the cancel"
        events += evs
        if cancelled_at is None and any(e.request_id == r_b and e.codes.shape[1] for e in evs):
            srv.cancel(r_b)
            cancelled_at = rounds
    assert cancelled_at is not None
    codes, done = collect(events)
    assert r_b not in done and codes[r_b].shape[1] < 32
    np.testing.assert_array_equal(codes[r_b], solo_b[:, :codes[r_b].shape[1]])
    np.testing.assert_array_equal(codes[r_a], solo_a)
    np.testing.assert_array_equal(codes[r_c], solo_c)
    assert {r_a, r_c} <= done


def test_per_request_voice_references(engine):
    """A request with its own references samples its solo run with the same
    references; a co-tenant without them is unaffected."""
    ref = random_ref(3, 7)
    voiced = solo_codes(engine, "voiced request", 61, 14, prompt_text=["ref transcript"],
                        prompt_tokens=[ref])
    plain = solo_codes(engine, "plain request", 62, 14)
    srv = ContinuousBatcher(engine, slots=2)
    r_v = submit(srv, "voiced request", 14, 61, prompt_text=["ref transcript"],
                 prompt_tokens=[ref])
    r_p = submit(srv, "plain request", 14, 62)
    codes, done = collect(srv.run())
    assert {r_v, r_p} <= done
    np.testing.assert_array_equal(codes[r_v], voiced)
    np.testing.assert_array_equal(codes[r_p], plain)


def test_per_request_refs_conflict_with_session_prefix(engine):
    ref = np.zeros((K, 4), np.int64)
    engine.set_prefix(["session voice"], [ref])
    try:
        srv = ContinuousBatcher(engine, slots=1)
        with pytest.raises(ValueError, match="prefix"):
            submit(srv, "x", 4, 1, prompt_text=["v"], prompt_tokens=[ref])
    finally:
        engine.clear_prefix()


def test_priority_admission_order(engine):
    """With one slot, a late high-priority request admits before earlier
    ones (FIFO within a level), and every request keeps its solo codes."""
    solos = {i: solo_codes(engine, f"prio {i}", 70 + i, 6) for i in range(3)}
    srv = ContinuousBatcher(engine, slots=1)
    r0 = submit(srv, "occupier", 6, 69)
    rids = {i: submit(srv, f"prio {i}", 6, 70 + i, priority=10 if i == 2 else 0)
            for i in range(3)}
    order, events = [], []
    for ev in srv.run():
        events.append(ev)
        if ev.request_id not in order and ev.request_id != r0:
            order.append(ev.request_id)
    assert order == [rids[2], rids[0], rids[1]]
    codes, _ = collect(events)
    for i in range(3):
        np.testing.assert_array_equal(codes[rids[i]], solos[i])


def test_deadline_auto_cancels(engine):
    """A request past its deadline while queued ends with one empty done
    event; one with a generous deadline completes."""
    srv = ContinuousBatcher(engine, slots=1)
    r_slow = submit(srv, "long occupier", 24, 81)
    r_dead = submit(srv, "will expire", 8, 82, timeout_s=1e-6)
    r_ok = submit(srv, "will finish", 8, 83, timeout_s=600.0)
    events = list(srv.run())
    dead = [e for e in events if e.request_id == r_dead]
    assert len(dead) == 1 and dead[0].done and dead[0].codes.shape[1] == 0
    _, done = collect(events)
    assert {r_slow, r_ok, r_dead} <= done
    assert srv.stats()["expired"] == 1


def test_queue_backpressure_and_stats(engine):
    srv = ContinuousBatcher(engine, slots=1, max_queue=2)
    rids = [submit(srv, f"bp {i}", 6, 50 + i) for i in range(2)]
    with pytest.raises(QueueFull):
        submit(srv, "over the cap", 6, 59)
    _, done = collect(srv.run())
    assert set(rids) <= done
    st = srv.stats()
    assert st["completed"] == 2 and st["queue_depth"] == 0
    assert st["live_slots"] == 0 and st["slots"] == 1
    assert 0 <= st["queue_wait_p50_s"] <= st["queue_wait_p95_s"]
    assert st["ttft_p50_s"] >= st["queue_wait_p50_s"]
    assert st["frames_per_request_s"] > 0


def test_per_request_sampling_params(engine):
    s1 = solo_codes(engine, "cool stream", 7, 12, temperature=0.5, top_p=0.6)
    s2 = solo_codes(engine, "hot stream", 8, 12, temperature=1.3, repetition_penalty=1.4)
    srv = ContinuousBatcher(engine, slots=2)
    r1 = submit(srv, "cool stream", 12, 7, temperature=0.5, top_p=0.6)
    r2 = submit(srv, "hot stream", 12, 8, temperature=1.3, repetition_penalty=1.4)
    codes, _ = collect(srv.run())
    np.testing.assert_array_equal(codes[r1], s1)
    np.testing.assert_array_equal(codes[r2], s2)


def test_mixed_bucket_group_admission(monkeypatch):
    """Two requests admitted in one round whose prompts fall in different
    buckets each prefill alone at their own bucket, as their solo runs do,
    and keep their solo codes."""
    eng = make_engine(prompt_buckets=(16, 32))
    short, long = "hi", "bucket two here"
    solo_s, solo_l = solo_codes(eng, short, 41, 12), solo_codes(eng, long, 42, 12)
    srv = ContinuousBatcher(eng, slots=2)
    rounds, widths = [], []
    admit, prefill = srv._admit_many, tdecode.prefill

    def spy_admit(slots, reqs):
        rounds.append(len(reqs))
        return admit(slots, reqs)

    def spy_prefill(params, rope, state, prompt, *a, **k):
        widths.append(tuple(prompt.shape))
        return prefill(params, rope, state, prompt, *a, **k)

    srv._admit_many = spy_admit
    monkeypatch.setattr(tdecode, "prefill", spy_prefill)
    r_s, r_l = submit(srv, short, 12, 41), submit(srv, long, 12, 42)
    codes, done = collect(srv.run())
    assert {r_s, r_l} <= done
    assert rounds == [2] and widths == [(1, K + 1, 16), (1, K + 1, 32)]
    np.testing.assert_array_equal(codes[r_s], solo_s)
    np.testing.assert_array_equal(codes[r_l], solo_l)


def test_serve_with_voice_prefix(engine):
    engine.set_prefix(["ref text"], [random_ref(3, 8)])
    try:
        solo = solo_codes(engine, "with a voice", 31, 14)
        srv = ContinuousBatcher(engine, slots=2)
        rid = submit(srv, "with a voice", 14, 31)
        codes, done = collect(srv.run())
        assert rid in done
        np.testing.assert_array_equal(codes[rid], solo)
    finally:
        engine.clear_prefix()


def test_prefix_change_between_prepare_and_admission_fails_request(engine):
    """A prefix set between ``prepare`` and admission fails the stale
    request (one final done event, no audio); the co-tenant decodes against
    the new prefix, as its solo run does."""
    srv = ContinuousBatcher(engine, slots=2)
    stale = srv.prepare("prepared before prefix", max_new_tokens=12, seed=80)
    engine.set_prefix(["ref transcript"], [random_ref(0, 4)])
    try:
        srv.enqueue(stale)
        ok = submit(srv, "healthy co-tenant", 12, 81)
        codes, done = collect(srv.run())
        assert stale.id in done and (stale.id not in codes or codes[stale.id].shape[1] == 0)
        assert ok in done
        np.testing.assert_array_equal(codes[ok], solo_codes(engine, "healthy co-tenant", 81, 12))
    finally:
        engine.clear_prefix()


def test_same_length_prefix_swap_fails_request(engine):
    engine.set_prefix(["ref transcript"], [random_ref(0, 4)])
    try:
        srv = ContinuousBatcher(engine, slots=2)
        stale = srv.prepare("vs A", max_new_tokens=8, seed=85)
        n = engine._prefix_snapshot()[2]
        engine.set_prefix(["ref transcript"], [random_ref(1, 4)])
        assert engine._prefix_snapshot()[2] == n == int(engine._prefix_state["pos"][0])
        srv.enqueue(stale)
        codes, done = collect(srv.run())
        assert stale.id in done and (stale.id not in codes or codes[stale.id].shape[1] == 0)
    finally:
        engine.clear_prefix()


def test_prefix_swap_while_prepare_reads_it(engine):
    """A prefix set just after ``prepare`` read the published one (as a
    handler thread's ``prepare`` can race a ``set_prefix``): the request
    keeps the old state's generation and length together, and admission
    fails it as stale while the co-tenant decodes against the new prefix."""
    engine.set_prefix(["ref transcript"], [random_ref(0, 4)])
    old = engine._prefix_snapshot()
    base, armed = type(engine), [True]

    class SwapAfterRead(base):
        def __getattribute__(self, name):
            value = base.__getattribute__(self, name)
            if name == "_prefix_ref" and armed and armed.pop():
                self.set_prefix(["ref transcript"], [random_ref(1, 3)])
            return value

    try:
        srv = ContinuousBatcher(engine, slots=2)
        engine.__class__ = SwapAfterRead
        try:
            stale = srv.prepare("vs A", max_new_tokens=8, seed=86)
        finally:
            engine.__class__ = base
        new = engine._prefix_snapshot()
        assert not armed and new[1] != old[1] and new[2] != old[2]
        assert (stale.prefix_gen, stale.prefix_len) == old[1:]
        assert new[2] == int(new[0]["pos"][0])
        srv.enqueue(stale)
        ok = submit(srv, "healthy co-tenant", 8, 87)
        codes, done = collect(srv.run())
        assert stale.id in done and (stale.id not in codes or codes[stale.id].shape[1] == 0)
        assert ok in done
        np.testing.assert_array_equal(codes[ok], solo_codes(engine, "healthy co-tenant", 87, 8))
    finally:
        engine.clear_prefix()


def test_rejected_admission_onto_dirty_slot_forces_finish(engine):
    """A stale-prefix rejection on a predictively retired slot keeps that
    slot's force-finish: the pool drains with every slot done."""
    srv = ContinuousBatcher(engine, slots=1)
    first = submit(srv, "budget bound occupant", 6, 90)
    ev1 = srv.step()  # admit + dispatch (dispatched 1 + 8 >= 6: dirty)
    assert srv._dirty == {0}
    stale = srv.prepare("stale against new prefix", max_new_tokens=6, seed=91)
    engine.set_prefix(["ref transcript"], [random_ref(1, 4)])
    try:
        srv.enqueue(stale)
        events = ev1 + list(srv.run())
    finally:
        engine.clear_prefix()
    _, done = collect(events)
    assert first in done and stale.id in done
    assert not srv.busy and srv._dirty == set()
    assert bool(srv._state["done"].all())


def test_reset_recovers_from_a_failed_step(engine, monkeypatch):
    """A step that fails mid-round leaves the pool half written; ``reset``
    drops every request and the pool serves the next one exactly."""
    solo = solo_codes(engine, "after the reset", 95, 8)
    srv = ContinuousBatcher(engine, slots=2)
    submit(srv, "doomed live request", 20, 93)
    srv.step()

    def broken(*a, **k):
        srv._state["kv"]["k"].fill_(float("nan"))
        raise RuntimeError("device failure")

    with monkeypatch.context() as m:
        m.setattr(srv, "_decode", broken)
        with pytest.raises(RuntimeError):
            srv.step()
    srv.reset()
    assert not srv.busy and srv.stats()["live_slots"] == 0
    assert bool(srv._state["done"].all()) and not srv._state["kv"]["k"].isnan().any()
    ok = submit(srv, "after the reset", 8, 95)
    codes, done = collect(srv.run())
    assert ok in done
    np.testing.assert_array_equal(codes[ok], solo)


def test_pool_cache_grows_and_shrinks_with_load(engine, monkeypatch):
    """With a small ``CACHE_FLOOR`` the pool starts at a small allocation,
    moves to larger ones as its stream lengthens and back when it retires,
    each time into a state of its own; the codes are the solo run's."""
    monkeypatch.setattr(tgenerate, "CACHE_FLOOR", 8)
    solo = solo_codes(engine, "grow the pool", 9, 24)
    srv = ContinuousBatcher(engine, slots=2)
    sizes = [srv._alloc]
    assert sizes[0] < T_CFG.max_seq_len
    rid = submit(srv, "grow the pool", 24, 9)
    events = []
    while srv.busy:
        events += srv.step()
        sizes.append(srv._alloc)
    codes, done = collect(events)
    assert rid in done
    np.testing.assert_array_equal(codes[rid], solo)
    assert max(sizes) > sizes[0]
    submit(srv, "x", 1, 1)
    srv.step()  # a short request alone: back to a small allocation
    assert srv._alloc < max(sizes)
    ptrs = {s["kv"]["k"].data_ptr() for s in srv._states.values()}
    assert len(ptrs) == len(srv._states) == len(set(srv.allocs))


def test_shrink_past_a_done_slot(engine, monkeypatch):
    """A finished long request's slot stays done at its last position; when
    a short co-tenant alone moves the pool to a smaller allocation, that
    position lies past it: the decode must neither write there nor change
    the co-tenant's codes."""
    monkeypatch.setattr(tgenerate, "CACHE_FLOOR", 8)
    solo_s = solo_codes(engine, "short", 7, 40)
    srv = ContinuousBatcher(engine, slots=2)
    r_l = submit(srv, "the long one goes first", 60, 6)
    events = []
    for _ in range(5):
        events += srv.step()
    r_s = submit(srv, "short", 40, 7)
    shrunk = False
    while srv.busy:
        events += srv.step()
        pos = srv._state["pos"].max().item()
        shrunk |= bool(srv._state["done"].any()) and pos >= srv._alloc - 1
    codes, done = collect(events)
    assert {r_l, r_s} <= done and shrunk
    np.testing.assert_array_equal(codes[r_s], solo_s)


def test_resize_cache_and_mark_done_work_in_place(engine):
    """``decode.resize_cache`` moves a state into another allocation's in
    place: live rows copied, rows above them zeroed, the other fields as
    they were but positions clamped into the allocation; ``mark_done`` sets
    done flags in place."""
    gen = torch.Generator().manual_seed(0)
    src = tdecode.init_state(engine.params, T_CFG, batch=2, max_seq_len=64)
    for t in tdecode._tensors(src):
        t.copy_(torch.randint(0, 5, t.shape, generator=gen).to(t.dtype))
    small = tdecode.init_state(engine.params, T_CFG, batch=2, max_seq_len=32)
    big = tdecode.init_state(engine.params, T_CFG, batch=2, max_seq_len=128)
    big["kv"]["k"].fill_(7.0)
    ptr = big["kv"]["k"].data_ptr()
    assert tdecode.resize_cache(src, big) is big and big["kv"]["k"].data_ptr() == ptr
    torch.testing.assert_close(big["kv"]["k"][:, :, :, :64], src["kv"]["k"])
    assert not big["kv"]["k"][:, :, :, 64:].any()
    tdecode.resize_cache(src, small)
    torch.testing.assert_close(small["kv"]["v"], src["kv"]["v"][:, :, :, :32])
    for k in ("frame", "prev", "step", "done", "sampling", "noise_key"):
        torch.testing.assert_close(small[k], src[k])
        torch.testing.assert_close(big[k], src[k])
    src["pos"].copy_(torch.tensor([5, 40], dtype=torch.int32))
    tdecode.resize_cache(src, small)
    assert small["pos"].tolist() == [5, 31]  # clamped into the allocation
    small["done"].zero_()
    tdecode.mark_done(small, torch.tensor([False, True]))
    assert small["done"].tolist() == [False, True]


def test_prepare_input_validation(engine):
    srv = ContinuousBatcher(engine, slots=1)
    for kw in ({"temperature": 0.0}, {"top_p": 5.0}, {"repetition_penalty": 2.5},
               {"max_new_tokens": -3}):
        with pytest.raises(ValueError):
            srv.prepare("x", **kw)
    with pytest.raises(ValueError, match="Prompt is too long"):
        srv.prepare("word " * 40)


def test_concurrent_prepares_get_distinct_keys(engine):
    """Unseeded prepares from many threads draw distinct noise keys, and
    their prompts equal a serial encode (the native BPE encoder shares one
    read-only vocabulary between threads)."""
    srv = ContinuousBatcher(engine, slots=1)
    texts = [f"key race probe {i} with some more words" for i in range(32)]
    want = {t: srv.prepare(t, seed=0).values for t in texts}
    got, errs, lock = [], [], threading.Lock()

    def worker(t):
        try:
            req = srv.prepare(t)
            with lock:
                got.append((t, req))
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(t,)) for t in texts]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errs and len(got) == 32
    assert len({req.key for _, req in got}) == 32
    for t, req in got:
        np.testing.assert_array_equal(req.values, want[t])


def test_cancel_then_expiry_stays_silent(engine):
    srv = ContinuousBatcher(engine, slots=1)
    r_live = submit(srv, "keeps the pool busy", 30, 70)
    r_gone = submit(srv, "cancelled then expires", 30, 71, timeout_s=0.15)
    srv.cancel(r_gone)
    time.sleep(0.2)
    events = list(srv.run())
    assert all(ev.request_id != r_gone for ev in events)
    assert any(ev.request_id == r_live and ev.done for ev in events)


def test_scheduler_soak_random_interleaving(engine):
    """Staggered submits with mixed priorities and budgets and random
    cancels over three slots: the pool drains, every request not cancelled
    ends once with its solo codes, a cancelled one emits nothing a round
    after its cancel and what it emitted is a prefix of its solo run, and
    ``frames_total`` counts the frames delivered."""
    rng = np.random.RandomState(1234)
    plans = [{"text": f"soak request {i}", "seed": 500 + i, "max_new": int(rng.randint(4, 20)),
              "priority": int(rng.randint(0, 3))} for i in range(10)]
    solos = {p["seed"]: solo_codes(engine, p["text"], p["seed"], p["max_new"]) for p in plans}
    srv = ContinuousBatcher(engine, slots=3, max_queue=64)
    pending, submitted, cancelled_at = list(plans), {}, {}
    seen, parts, done_ids, round_i = {}, {}, set(), 0
    while pending or srv.busy:
        for _ in range(int(rng.randint(0, 3))):
            if pending:
                p = pending.pop()
                submitted[submit(srv, p["text"], p["max_new"], p["seed"],
                                 priority=p["priority"])] = p
        live = [r for r in submitted if r not in done_ids and r not in cancelled_at]
        if live and (rng.rand() < 0.2 or (round_i == 4 and not cancelled_at)):
            victim = live[int(rng.randint(len(live)))]
            srv.cancel(victim)
            cancelled_at[victim] = round_i
        if srv.busy:
            for ev in srv.step():
                rid = ev.request_id
                assert rid in submitted and rid not in done_ids
                if rid in cancelled_at:
                    assert round_i <= cancelled_at[rid] + 1
                if ev.codes.shape[1]:
                    parts.setdefault(rid, []).append(ev.codes)
                    seen[rid] = seen.get(rid, 0) + ev.codes.shape[1]
                    assert ev.frames_total == seen[rid]
                if ev.done:
                    done_ids.add(rid)
        round_i += 1
        assert round_i < 2000
    st = srv.stats()
    assert not srv.busy and st["live_slots"] == 0 and st["queue_depth"] == 0
    for rid, p in submitted.items():
        solo = solos[p["seed"]]
        got = np.concatenate(parts[rid], axis=1) if rid in parts else solo[:, :0]
        if rid in done_ids:
            np.testing.assert_array_equal(got, solo)
        else:
            assert rid in cancelled_at
            np.testing.assert_array_equal(got, solo[:, :got.shape[1]])
    assert done_ids and cancelled_at


def test_batch_call_between_rounds_leaves_the_pool(engine):
    """A ``generate_batch`` of the pool's batch size between two rounds
    resets the engine's own (B, alloc) state, never the pool's: the served
    codes stay their solo runs'."""
    solo_a = solo_codes(engine, "first request text", 11, 30)
    solo_b = solo_codes(engine, "second one here", 12, 30)
    srv = ContinuousBatcher(engine, slots=2)
    r_a, r_b = submit(srv, "first request text", 30, 11), submit(srv, "second one here", 30, 12)
    events = srv.step() + srv.step()
    engine.generate_batch(["a batch", "of two"], max_new_tokens=20)
    pool = {s["kv"]["k"].data_ptr() for s in srv._states.values()}
    assert engine._states and not pool & {s["kv"]["k"].data_ptr()
                                          for s in engine._states.values()}
    events += list(srv.run())
    codes, done = collect(events)
    assert {r_a, r_b} <= done
    np.testing.assert_array_equal(codes[r_a], solo_a)
    np.testing.assert_array_equal(codes[r_b], solo_b)


# --- the port's batcher against the JAX package's ------------------------------


ENGINE = dict(prompt_buckets=(16, 32, 64), decode_chunk=8, first_chunk=4, batch_chunk=16)
# four requests over two slots, in two prompt buckets, each with its own
# sampling; the last two join a running pool
JAX_REQUESTS = [("hello there", 12, 33, dict(temperature=0.6, top_p=0.7, repetition_penalty=1.0)),
                ("hi", 20, 34, dict(temperature=1.1, top_p=0.95, repetition_penalty=1.3)),
                ("ok go now", 9, 35, SAMPLING),
                ("a late joiner", 14, 36, dict(temperature=0.8, top_p=0.9, repetition_penalty=1.2))]


def request_key(seed: int):
    """The JAX batcher's slot key of a request with ``seed``."""
    return jax.random.fold_in(jax.random.split(jax.random.PRNGKey(seed))[1], 0)


def replay_request_noise(slot_key):
    """A host source replaying the JAX batcher's draws for one request: the
    frame at ``step`` (the prefill's at ``PREFILL_STEP``) from
    ``fold_in(slot_key, step)``, split into a slow and a fast key, the fast
    one split per residual book."""

    @jax.jit
    def keys(step):
        return jax.random.split(jax.random.fold_in(slot_key, step))

    draw_slow = jax.jit(lambda k, n: jax.random.gumbel(k, (n,), jnp.float32),
                        static_argnums=1)
    draw_fast = jax.jit(lambda k, n: jax.vmap(lambda kk: jax.random.gumbel(
        kk, (n,), jnp.float32))(jax.random.split(k, K - 1)), static_argnums=1)

    def noise(slot, step, d: tdecode.Draws):
        assert d.per_book and slot == 0
        ks, kf = keys(jnp.uint32(step % 2**32))
        return (torch.from_numpy(np.array(draw_slow(ks, d.slow))),
                torch.from_numpy(np.array(draw_fast(kf, d.fast))))

    return noise


def drive(srv, submit_one) -> dict[int, list]:
    """The staggered schedule: two requests, two rounds, then the rest; the
    events per request in order, by submission index."""
    ids = [submit_one(srv, i) for i in range(2)]
    events = srv.step() + srv.step()
    ids += [submit_one(srv, i) for i in range(2, len(JAX_REQUESTS))]
    events += list(srv.run())
    out = {i: [] for i in range(len(ids))}
    for ev in events:
        out[ids.index(ev.request_id)].append(ev)
    return out


def test_events_match_the_jax_batcher(monkeypatch):
    """Four requests staggered over two slots through both packages'
    batchers: per request the same events (frames, done flags,
    ``frames_total``), and the codes and slow tokens that the JAX batcher
    must serve, its solo runs' (its own rule), a first difference only at a
    knife edge of the port's decision."""
    import tempfile
    from pathlib import Path

    path = Path(tempfile.mkdtemp()) / "tokenizer.tiktoken"
    write_tiny_vocab(path)
    specials = tiny_special_tokens(T_CFG.codebook_size)
    jp = jdual.init_params(jax.random.PRNGKey(0), J_CFG, jnp.float32)
    tp = tckpt.from_jax_params(jax.tree_util.tree_map(np.asarray, jp))
    jeng = JEngine(jp, J_CFG, JTokenizer(path, specials), JEngineConfig(**ENGINE), seed=3)
    teng = GenerationEngine(tp, T_CFG, TTokenizer(path, specials),
                            EngineConfig(**ENGINE, fast_kernel=False))

    def jsubmit(srv, i):
        text, n, seed, kw = JAX_REQUESTS[i]
        return srv.submit(text, max_new_tokens=n, seed=seed, **kw)

    def tsubmit(srv, i):
        text, n, seed, kw = JAX_REQUESTS[i]
        return srv.submit(text, max_new_tokens=n, noise=replay_request_noise(request_key(seed)),
                          **kw)

    def jax_solo(text, n, seed, kw):
        """A JAX solo run after ``reseed(seed)``: its codes and its slow
        tokens, which the codes omit (read from each device call's frames)."""
        calls = []

        def record(fn):
            def call(*a, **k):
                state, frames, emitted = fn(*a, **k)
                if not isinstance(frames, jax.core.Tracer):  # not a call inside a trace
                    calls.append((np.asarray(frames)[0], np.asarray(emitted)[0]))
                return state, frames, emitted
            return call

        with monkeypatch.context() as m:
            m.setattr(jdecode, "prefill_chunk", record(jdecode.prefill_chunk))
            m.setattr(jdecode, "decode_chunk", record(jdecode.decode_chunk))
            jeng.reseed(seed)
            codes = np.concatenate([r.codes for r in jeng.generate_long(
                text, max_new_tokens=n, streaming=True, **kw) if r.action == "sample"], axis=1)
        tokens = np.concatenate([f[e][:, 0] for f, e in calls])[:codes.shape[1]]
        return codes, tokens

    # The JAX batcher serves a request its solo run's codes (its own rule,
    # which on XLA:CPU it now and then breaks: ROADMAP.md, section 3), so the
    # port's codes are held against the solo runs; one batcher run gives the
    # events' structure, which the budgets and the schedule set.
    jsolos = [jax_solo(*r) for r in JAX_REQUESTS]
    want = drive(JBatcher(jeng, slots=2), jsubmit)
    # the port's decisions, and per frame the rows' (request, step) and the
    # index of its first decision
    seen, frames = Decisions(monkeypatch), []
    record = tdecode.sample

    def frozen(gumbel, logits, temperature, top_p, *a, **k):
        # the pool's sampling columns are views of its state, which later
        # admissions overwrite: record them as they were
        return record(gumbel, logits, temperature.clone(), top_p.clone(), *a, **k)

    monkeypatch.setattr(tdecode, "sample", frozen)
    host_draws = tdecode._host_draws

    def spy(noise, step, draws, device):
        frames.append(([r.id if r is not None else None for r in noise.reqs], step.tolist(),
                       len(seen.calls)))
        return host_draws(noise, step, draws, device)

    monkeypatch.setattr(tdecode, "_host_draws", spy)
    tsrv = ContinuousBatcher(teng, slots=2)
    got = drive(tsrv, tsubmit)
    # per (request, frame): the frame's first decision and the request's row
    where = {}
    for rids, steps, first in frames:
        for b, (rid, st) in enumerate(zip(rids, steps)):
            where.setdefault((rid, 0 if st == tdecode.PREFILL_STEP else st + 1), (first, b))
    for i in range(len(JAX_REQUESTS)):
        assert [(e.codes.shape[1], e.done, e.frames_total) for e in got[i]] == \
            [(e.codes.shape[1], e.done, e.frames_total) for e in want[i]], i
        tid = got[i][0].request_id
        g = np.concatenate([e.codes for e in got[i]], axis=1)
        w, w_tokens = jsolos[i]
        n = min(g.shape[1], w.shape[1])
        # full frames: the slow token itself, then the codes (whose first
        # row, clamped from the token, can hide a differing token)
        tokens = [int(seen.calls[where[(tid, f)][0]][5][where[(tid, f)][1]]) for f in range(n)]
        gf = np.concatenate([np.array(tokens)[None], g[:, :n]])
        wf = np.concatenate([w_tokens[None, :n], w[:, :n]])
        diff = np.argwhere(gf != wf)
        if not len(diff):
            assert g.shape == w.shape, i
            continue
        f = int(diff[:, 1].min())
        row = int(diff[diff[:, 1] == f][:, 0].min())
        assert row != 1, "the first code follows the slow token"
        first, b = where[(tid, f)]
        top_k, logits, gumbel, temperature, top_p, picks = seen.calls[first + max(row - 1, 0)]
        assert int(picks[b]) == gf[row, f]
        r = slice(b, b + 1)
        m = testing.sample_decision_margins(
            torch.tensor([int(wf[row, f])]), picks[r], logits[r], gumbel[r], temperature[r],
            top_p[r], top_k, LOGIT_TOL * float(logits[b].abs().max()))
        assert not m["failures"], (i, f, row, m["failures"])
