"""Continuous batching: port of ``fish_tts_tpu/engine/serve.py``.

A fixed pool of B slots decodes in one batched state; queued requests join
the running decode between chunks, without disturbing the other slots.

- The pool owns its decode states (one per KV allocation) and the decode
  graphs captured on them.  A captured graph holds its state's addresses,
  so nothing else may reset that state: the engine's own (B, alloc) states,
  which ``synthesize_batch`` resets in place, are never the pool's.  Free
  slots sit with ``done`` set, so the decode holds them, and a frame after
  every slot is done is skipped on the device.
- Admission (:meth:`ContinuousBatcher._admit_many`) prefills each request
  admitted in a round alone, at its own prompt bucket, in a one-row scratch
  state of the pool's own (JAX's ``scratch_seq`` and ``rows``), then copies
  the row into its slot in place: the KV rows below ``rows``, ``frame``,
  ``pos`` and ``done``, with ``prev`` and ``step`` zeroed and the slot's
  sampling column and noise key written.  The other slots' rows are
  untouched and decode on in the next chunk.  JAX prefills the round's
  requests as one group at the largest member's bucket; on the card the
  plain prefill's GEMMs round a row differently with the group's size and
  bucket, which would make a request's codes depend on its co-tenants,
  while the decode kernels give a row the same bits at any batch size.
- Reproducibility: each request carries its own noise key, the slot-0 key
  of the source a solo ``generate_long`` would draw (``seed`` as after
  ``engine.reseed(seed)``), and the state keeps per-slot steps, so a
  request's codes equal its solo run whoever its co-tenants are and
  whenever it was admitted.  The prefill frame draws at
  ``decode.PREFILL_STEP``, as a solo prefill does.
- Token budgets are enforced by predictive retirement: a slot whose
  dispatched frames will reach its request's budget is freed at dispatch,
  and force-finished after its last chunk unless a successor claims it.
  Only an EOS on the device pays the one speculative chunk in flight.
- The allocation follows the live streams (``_pool_resize``: powers of two
  from ``CACHE_FLOOR``), and the read window steps by ``kv_bucket_step``
  rows; each (allocation, window) pair is one captured graph, made the
  first time it is met.  ``graph_captures``/``capture_s``/``allocs`` count
  them.
- Chunk k + 1 is launched before chunk k is read back, and an admission's
  first frame stays on the device until the request's first chunk is read.
  No launch path of a round reads a device tensor back.

On the CPU each chunk runs the eager loop; a request may then carry a host
noise source of its own (``prepare(noise=)``), called as ``noise(0, step,
draws)`` for the slot it holds, as in its solo run.  On the card every
decode frame is a graph replay and the noise is the counter-based default.
On an engine's (dp, tp) mesh the pool's caches are sharded like the
engine's, allocated at the full context and never resized, admission
installs into the sharded cache, and each chunk runs the eager loop.

Events are streaming-semantics (each emitted frame, the EOS frame
included); callers that want batch semantics drop the final frame.
``submit``/``prepare``/``enqueue``/``cancel`` are thread-safe; all device
work runs on the thread that calls :meth:`ContinuousBatcher.step`, on the
CUDA stream that was current when the pool was made.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from fish_tts_tpu_torch.engine import decode as decode_mod
from fish_tts_tpu_torch.engine.generate import (GenerationEngine, _cache_bucket, _kv_bucket,
                                                _pick_bucket, start_fetch, to_device_async)
from fish_tts_tpu_torch.models.prompt import build_prompt

logger = logging.getLogger(__name__)


class QueueFull(RuntimeError):
    """Raised by ``submit`` when the request queue is at ``max_queue``
    (backpressure: the caller should retry later or shed load)."""


@dataclass
class Event:
    """One scheduler-round outcome for one request."""

    request_id: int
    codes: np.ndarray  # (num_codebooks, m) new vocoder rows this round
    done: bool
    frames_total: int  # cumulative emitted frames for this request
    slot: int = -1  # pool slot that decoded this chunk (stable per request)


@dataclass
class _Request:
    id: int
    values: np.ndarray  # (1+K, T) prompt matrix
    max_new: int
    temperature: float
    top_p: float
    repetition_penalty: float
    key: int  # the slot's noise key (a GumbelNoise slot key)
    noise: decode_mod.HostNoise | None = None  # a host source (CPU only)
    produced: int = 0
    prompt_len: int = 0  # full context length (prefix + prompt)
    prefix_len: int = 0  # engine prefix length at prepare() time (0 = none)
    prefix_gen: int = 0  # engine prefix generation at prepare() time
    priority: int = 0  # higher admits first (FIFO within a priority)
    deadline: float = 0.0  # time.monotonic() deadline; 0 = none
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first: float = 0.0  # first frames delivered to the consumer
    # frames that will exist once every chunk in flight lands (the prefill
    # frame counts 1, each dispatched chunk ``chunk``): the budget lookahead
    # of predictive retirement
    dispatched: int = 1
    finished: bool = False  # done event emitted; drop any late frames
    # the admission's first frame: (its host copy (1, 1+K), the copy's CUDA
    # event or None), read with the request's first chunk
    first_dev: tuple | None = None


class ContinuousBatcher:
    """Slot scheduler over one batched decode state.

    >>> srv = ContinuousBatcher(engine, slots=4)
    >>> rid = srv.submit("hello world", max_new_tokens=200)
    >>> for ev in srv.run():
    ...     consume(ev.request_id, ev.codes, ev.done)
    """

    def __init__(self, engine: GenerationEngine, slots: int = 8, chunk: int | None = None,
                 max_queue: int = 0):
        self.engine = engine
        self.slots = slots
        self.chunk = chunk or engine.engine_cfg.decode_chunk
        #: queue backpressure bound; 0 = unbounded
        self.max_queue = max_queue
        self._lock = threading.Lock()
        self._queue: deque[_Request] = deque()
        self._cancelled: set[int] = set()
        self._done_stats: deque[dict] = deque(maxlen=1024)
        self._n_expired = 0
        self._ids = itertools.count()
        self._slot_req: list[_Request | None] = [None] * slots
        dev = engine.device
        self._stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
        # the pool's own states, one per KV allocation, the graphs captured
        # on them, and its admission scratch states
        self._states: dict[int, decode_mod.State] = {}
        self._graphs: dict[tuple, decode_mod.DecodeGraph] = {}
        self._scratch: dict[int, decode_mod.State] = {}
        self.graph_captures = 0
        self.capture_s = 0.0
        self._state = self._fresh_pool()
        self.allocs = [self._alloc]  # the allocations the pool went through
        # slots retired at dispatch (predictive budget retirement): the
        # device still decodes the request's final chunk, but the slot is
        # free to admit; if nothing claims it, it is force-finished
        self._dirty: set[int] = set()
        # one chunk in flight: (host frames, host emitted, copy event,
        # slot -> request at dispatch)
        self._pending = None

    # -- the pool's states ---------------------------------------------------

    @property
    def _alloc(self) -> int:
        return int(self._state["kv"]["k"].shape[3])

    def _pool_state(self, alloc: int) -> decode_mod.State:
        state = self._states.get(alloc)
        if state is None:
            eng = self.engine
            state = self._states[alloc] = decode_mod.init_state(
                eng.params, eng.cfg, batch=self.slots, max_seq_len=alloc,
                window=eng.engine_cfg.rep_penalty_window)
        return state

    def _fresh_pool(self) -> decode_mod.State:
        """The pool's state at the smallest allocation, reset, every slot done."""
        state = decode_mod.reset_state(self._pool_state(self._pool_floor()))
        state["done"].fill_(True)
        return state

    def _pool_floor(self) -> int:
        """The first allocation: the smallest bucket, or the full context on
        a mesh, where the pool is never resized."""
        return self.engine._alloc_rows(1)

    def _pool_resize(self, min_rows: int, grow_only: bool = False) -> None:
        """Move the pool to the allocation bucket of ``min_rows`` (every live
        slot's rows must sit below it).  Admission passes ``grow_only``: its
        bound covers only the incoming prompts.  A no-op on a mesh (JAX
        ``serve.py:263-277``)."""
        if self.engine.mesh is not None:
            return
        alloc = _cache_bucket(min_rows, self.engine.cfg.max_seq_len)
        cur = self._alloc
        if alloc > cur or (alloc < cur and not grow_only):
            self._state = decode_mod.resize_cache(self._state, self._pool_state(alloc))
            self.allocs.append(alloc)

    def _scratch_state(self, seq: int) -> decode_mod.State:
        """The one-row admission scratch of ``seq`` cache rows, reset."""
        state = self._scratch.get(seq)
        if state is None:
            eng = self.engine
            state = self._scratch[seq] = decode_mod.init_state(
                eng.params, eng.cfg, batch=1, max_seq_len=seq,
                window=eng.engine_cfg.rep_penalty_window)
            return state
        return decode_mod.reset_state(state)

    def on_stream(self):
        """A context that makes the pool's CUDA stream current (nothing on
        the CPU): every launch of a round and the events that wait on it."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    # -- submission --------------------------------------------------------

    def submit(self, text: str, **kw) -> int:
        """``prepare`` + ``enqueue`` in one call; see :meth:`prepare`."""
        return self.enqueue(self.prepare(text, **kw))

    def prepare(self, text: str, *, max_new_tokens: int = 2048, temperature: float = 0.7,
                top_p: float = 0.8, repetition_penalty: float = 1.1, seed: int | None = None,
                prompt_text: list[str] | None = None,
                prompt_tokens: list[np.ndarray] | None = None, priority: int = 0,
                timeout_s: float = 0.0, noise: decode_mod.HostNoise | None = None
                ) -> _Request:
        """Build a request (tokenize, prompt, noise key) without touching the
        scheduler's state; hand it to :meth:`enqueue`.

        - ``seed``: the request samples what ``engine.reseed(seed)`` and a
          solo ``generate_long`` sample; without it, the engine's next
          noise source is drawn.
        - ``prompt_text``/``prompt_tokens``: per-request voice references,
          inlined into the prompt as a solo ``generate_long`` would; they
          cannot be combined with the engine's cached prefix.
        - ``priority``: higher admits first (FIFO within a level; running
          requests are never preempted).  ``timeout_s``: a deadline from
          submission; a request still queued or decoding past it ends with
          one final empty ``done`` event (an explicit cancel is silent).
        - ``noise``: a host noise source for this request, called as
          ``noise(0, step, draws)`` (CPU only).

        Raises ``QueueFull`` at once when the queue is at ``max_queue``."""
        temperature, top_p = float(temperature), float(top_p)
        repetition_penalty = float(repetition_penalty)
        priority, timeout_s = int(priority), float(timeout_s)
        max_new_tokens = int(max_new_tokens)
        if not (0 < top_p <= 1 and 0 < repetition_penalty < 2 and 0 < temperature < 2):
            raise ValueError("sampling params out of range: need 0 < top_p <= 1, "
                             "0 < repetition_penalty < 2, 0 < temperature < 2")
        if max_new_tokens < 0:
            raise ValueError("max_new_tokens must be >= 0 (0 = unlimited)")
        eng = self.engine
        if noise is not None and eng.device.type == "cuda":
            raise TypeError("a host noise source runs only on the CPU: on a CUDA device the "
                            "noise is drawn inside the decode graph")
        with self._lock:
            self._check_queue_bound()
        source = eng._next_noise() if seed is None else eng._seed_noise(seed)
        has_refs = bool(prompt_text) or bool(prompt_tokens)
        # one consistent snapshot; admission re-checks the generation
        prefix_state, prefix_gen, prefix_len = eng._prefix_snapshot()
        if has_refs and prefix_state is not None:
            raise ValueError("per-request references cannot be combined with a session-level "
                             "cached prefix (engine.set_prefix); clear the prefix or drop the "
                             "per-request references")
        if prefix_state is not None:
            enc = eng._encode_suffix(text)
        else:
            enc = build_prompt(eng.tokenizer, text, eng.cfg.num_codebooks,
                               prompt_texts=prompt_text or [], prompt_codes=prompt_tokens or [])
        prompt_len = prefix_len + enc.values.shape[1]
        cfg = eng.cfg
        reserve = min(2048, cfg.max_seq_len // 2)
        if prompt_len > cfg.max_seq_len - reserve:
            raise ValueError(f"Prompt is too long: {prompt_len}")
        max_new = (min(max_new_tokens, cfg.max_seq_len - prompt_len) if max_new_tokens
                   else cfg.max_seq_len - prompt_len)
        now = time.monotonic()
        return _Request(
            id=next(self._ids), values=enc.values, max_new=max_new, temperature=temperature,
            top_p=top_p, repetition_penalty=repetition_penalty,
            key=source.slot_keys([0])[0], noise=noise,
            prompt_len=prompt_len, prefix_len=prefix_len, prefix_gen=prefix_gen,
            t_submit=now, priority=priority, deadline=(now + timeout_s) if timeout_s else 0.0)

    def _check_queue_bound(self) -> None:
        """Raise ``QueueFull`` at the bound.  The caller holds ``_lock``."""
        if self.max_queue and len(self._queue) >= self.max_queue:
            raise QueueFull(f"serve queue is full ({self.max_queue} requests)")

    def enqueue(self, req: _Request) -> int:
        """Queue a prepared request (cheap, thread-safe); returns its id."""
        with self._lock:
            self._check_queue_bound()
            self._queue.append(req)
        return req.id

    def cancel(self, request_id: int) -> None:
        """Abort a request at the next round: a queued one is dropped, a
        running one stops decoding and frees its slot.  No further events
        are emitted for it."""
        with self._lock:
            self._cancelled.add(request_id)

    def _apply_cancels(self) -> None:
        with self._lock:
            if not self._cancelled:
                return
            cancelled, self._cancelled = self._cancelled, set()
            self._queue = deque(r for r in self._queue if r.id not in cancelled)
        for i, req in enumerate(self._slot_req):
            if req is not None and req.id in cancelled:
                req.finished = True  # drop its frames in flight
                self._slot_req[i] = None
                self._dirty.add(i)  # force-finish unless a successor claims it
        if self._pending is not None:
            # a predictively retired request's final chunk is reachable only
            # through the snapshot in flight
            for req in self._pending[3].values():
                if req is not None and req.id in cancelled:
                    req.finished = True

    # -- internals ---------------------------------------------------------

    def _free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self._slot_req) if r is None]

    def _admit_many(self, slot_ids: list[int], reqs: list[_Request]
                    ) -> tuple[list[_Request], list[int]]:
        """Prefill the requests admitted this round, each alone, and copy
        each row into its slot (see the module docstring).  Each first
        frame's host copy starts at once and is read with the request's
        first chunk.

        Returns ``(rejected, rejected_slots)``: requests encoded against
        another prefix generation than the one now held, and the slots
        they briefly held, which get no state and must be marked dirty again
        by the caller."""
        now = time.monotonic()
        for req in reqs:
            req.t_admit = now
        eng = self.engine
        cfg, ecfg = eng.cfg, eng.engine_cfg
        prefix, prefix_gen, prefix_len = eng._prefix_snapshot()
        kv_pre = _kv_bucket(prefix_len, ecfg.kv_bucket_step, cfg.max_seq_len) if prefix_len else 0

        # a request encoded against another prefix generation would decode
        # against a wrong context: fail it
        rejected = [r for r in reqs if r.prefix_gen != prefix_gen]
        rejected_slots: list[int] = []
        if rejected:
            logger.error("serve: engine prefix changed between prepare and admission (now %d) "
                         "for request(s) %s; failing them", prefix_len, [r.id for r in rejected])
            for s, r in zip(slot_ids, reqs):
                if r.prefix_gen != prefix_gen:
                    self._slot_req[s] = None
                    rejected_slots.append(s)
            keep = [(s, r) for s, r in zip(slot_ids, reqs) if r.prefix_gen == prefix_gen]
            slot_ids, reqs = [s for s, _ in keep], [r for _, r in keep]
            if not reqs:
                return rejected, rejected_slots

        cap = cfg.max_seq_len - 1
        # the install writes [:rows] of every admitted slot: grow first
        # (live streams may reach further, so never shrink here)
        self._pool_resize(_kv_bucket(max(r.prompt_len for r in reqs), ecfg.kv_bucket_step,
                                     cfg.max_seq_len) + 1, grow_only=True)
        dev = eng.device
        for slot, req in zip(slot_ids, reqs):
            # each request alone at its own bucket, as its solo run prefills
            bucket = _pick_bucket(ecfg.prompt_buckets, req.prompt_len - prefix_len, cap)
            rows = _kv_bucket(req.prompt_len, ecfg.kv_bucket_step, cfg.max_seq_len)
            # the scratch covers the whole padded write extent
            scratch = self._scratch_state(
                _kv_bucket(kv_pre + bucket + 1, ecfg.kv_bucket_step, cfg.max_seq_len))
            if prefix is not None:
                # prefill continues at the prefix's true length, reading
                # kv_pre rows
                eng._fork_into(prefix, scratch)
            padded = np.zeros((1, 1 + cfg.num_codebooks, bucket), np.int32)
            padded[0, :, :req.values.shape[1]] = req.values
            noise = (decode_mod.KeyedNoise([req.key]) if req.noise is None
                     else _RowNoise([req], cfg))
            _, first = decode_mod.prefill(
                eng.params, eng.rope, scratch, to_device_async(padded, dev),
                to_device_async(np.array([req.values.shape[1]], np.int32), dev), noise,
                req.temperature, req.top_p, req.repetition_penalty, cfg=cfg, ids=eng.ids,
                kv_bucket=kv_pre, **eng._options)
            self._install(scratch, slot, rows)
            self._slot_req[slot] = req
            req.first_dev = start_fetch(first)
        return rejected, rejected_slots

    @torch.no_grad()
    def _install(self, scratch: decode_mod.State, slot: int, rows: int) -> None:
        """Copy a one-row scratch into the pool's slot ``slot``, in place: KV
        rows below ``rows``, frame, position, done flag, sampling column and
        noise key; the penalty window and the step zeroed."""
        state = self._state
        for k in ("k", "v"):
            state["kv"][k].narrow(1, slot, 1).narrow(3, 0, rows).copy_(
                scratch["kv"][k].narrow(1, 0, 1).narrow(3, 0, rows))
        for k in ("frame", "pos", "done", "noise_key"):
            state[k][slot].copy_(scratch[k][0])
        state["sampling"][:, slot].copy_(scratch["sampling"][:, 0])
        state["prev"][slot].zero_()
        state["step"][slot].zero_()

    def _mark_done(self, slots) -> None:
        mask = np.zeros((self.slots,), bool)
        mask[list(slots)] = True
        decode_mod.mark_done(self._state, to_device_async(mask, self.engine.device))

    def _decode(self, kv_b: int):
        """One chunk of the pool: the eager loop on the CPU and on a mesh,
        replays of the pool's graph for (allocation, read window) on the
        card.  Returns (frames, emitted) on the device."""
        eng, state = self.engine, self._state
        if eng.device.type != "cuda" or eng.mesh is not None:
            noise = None
            if any(r is not None and r.noise is not None for r in self._slot_req):
                noise = _RowNoise(list(self._slot_req), eng.cfg)
            _, frames, emitted = decode_mod.decode_chunk(
                eng.params, eng.rope, state, noise, *state["sampling"], cfg=eng.cfg,
                ids=eng.ids, num_frames=self.chunk, kv_bucket=kv_b, early_exit=True,
                **eng._options)
            return frames, emitted
        key = (self._alloc, kv_b)
        graph = self._graphs.get(key)
        if graph is None:
            t = time.perf_counter()
            graph = self._graphs[key] = decode_mod.DecodeGraph(
                eng.params, eng.cfg, eng.ids, eng.rope, state, kv_bucket=kv_b,
                skip_done=True, capacity=self.chunk, **eng._options)
            self.graph_captures += 1
            self.capture_s += time.perf_counter() - t
        return graph.run(self.chunk)

    def step(self) -> list[Event]:
        """One scheduler round: admit queued requests into free slots, launch
        the pool's next chunk, then read the previous chunk back and route
        its frames.  A slot whose dispatched frames reach its request's
        budget is retired at dispatch; its successor admits in the next
        round, ordered on the stream after the final chunk."""
        with self.on_stream():
            return self._step()

    def _step(self) -> list[Event]:
        events: list[Event] = []
        now = time.monotonic()
        K = self.engine.cfg.num_codebooks
        with self._lock:
            pending = list(self._queue)
            already_cancelled = set(self._cancelled)
        expired = [req for req in list(self._slot_req) + pending
                   if req is not None and req.deadline and now > req.deadline
                   and not req.finished and req.id not in already_cancelled]
        if expired:
            ids = [r.id for r in expired]
            logger.info("serve: %d request(s) past deadline, cancelling: %s", len(ids), ids)
            with self._lock:
                self._cancelled.update(ids)
            # expiry ends the stream with one empty done event, and counts
            # in the stats like any completion
            for req in expired:
                req.finished = True
                self._record_done(req)
                self._n_expired += 1
                events.append(Event(req.id, np.zeros((K, 0), np.int64), True, req.produced, -1))
        self._apply_cancels()
        with self._lock:
            queued = len(self._queue)
        if queued:
            free = self._free_slots()
            take: list[_Request] = []
            with self._lock:
                if len(self._queue) > len(free) and any(r.priority for r in self._queue):
                    # stable sort: highest priority first, FIFO within a level
                    take = sorted(self._queue, key=lambda r: -r.priority)[:len(free)]
                    taken_ids = {r.id for r in take}
                    self._queue = deque(r for r in self._queue if r.id not in taken_ids)
                else:
                    while self._queue and len(take) < len(free):
                        take.append(self._queue.popleft())
                # claim the slots with the pop, under the same lock, so that
                # ``busy`` never sees a request in neither place
                for slot, req in zip(free, take):
                    self._slot_req[slot] = req
            if take:
                taken = free[:len(take)]
                rejected, rejected_slots = self._admit_many(taken, take)
                self._dirty -= set(taken)
                # a rejected request's slot got no state: its previous
                # occupant still needs the force-finish
                self._dirty |= set(rejected_slots)
                for req in rejected:
                    req.finished = True
                    self._record_done(req)
                    events.append(Event(req.id, np.zeros((K, 0), np.int64), True,
                                        req.produced, -1))
        if self._dirty:
            # retired slots no successor claimed, ordered after their final chunk
            self._mark_done(self._dirty)
            self._dirty.clear()

        live = [i for i, r in enumerate(self._slot_req) if r is not None]
        nxt = None
        if live:
            cfg, ecfg = self.engine.cfg, self.engine.engine_cfg
            # the read bound: the longest live context after this chunk, plus
            # one chunk, since results land one round late
            need = max(self._slot_req[i].prompt_len + self._slot_req[i].produced + self.chunk
                       for i in live) + self.chunk
            kv_b = _kv_bucket(need, ecfg.kv_bucket_step, cfg.max_seq_len)
            self._pool_resize(need)
            kv_b = min(kv_b, self._alloc)
            frames, emitted = self._decode(kv_b)
            nxt = (*start_fetch(frames, emitted), dict(enumerate(self._slot_req)))
            for i in live:  # predictive retirement, after the snapshot
                req = self._slot_req[i]
                req.dispatched += self.chunk
                if req.dispatched >= req.max_new:
                    self._slot_req[i] = None
                    self._dirty.add(i)

        if self._pending is not None:
            events += self._process(*self._pending)
        self._pending = nxt
        return events

    def _process(self, frames_host, emitted_host, copied, snapshot) -> list[Event]:
        """Read one chunk back and route its frames to the requests that held
        each slot when it was dispatched."""
        eng = self.engine
        if copied is not None:
            copied.synchronize()
        frames_np, emitted_np = frames_host.numpy(), emitted_host.numpy()
        events: list[Event] = []
        budget_done: list[int] = []
        n_tokens = 0
        for slot, req in snapshot.items():
            if req is None or req.finished:
                continue  # a free slot, or a speculative chunk past the end
            em = emitted_np[slot]
            fs = frames_np[slot][em]  # (m, 1+K)
            if req.first_dev is not None:
                # the admission's prefill frame rides this read
                host, first_copied = req.first_dev
                if first_copied is not None:
                    first_copied.synchronize()
                req.first_dev = None
                fs = np.concatenate([host.numpy(), fs], axis=0)
            if fs.shape[0] and not req.t_first:
                req.t_first = time.monotonic()
            fs = fs[:req.max_new - req.produced]
            n_tokens += fs.shape[0]
            req.produced += fs.shape[0]
            eos = fs.shape[0] > 0 and bool(fs[-1, 0] == eng.ids.im_end)
            done = (not bool(em[-1])) or eos or req.produced >= req.max_new
            if fs.shape[0]:
                codes = np.maximum(fs[:, 1:], 0).T.astype(np.int64)
                events.append(Event(req.id, codes, done, req.produced, slot))
            elif done:
                events.append(Event(req.id, np.zeros((eng.cfg.num_codebooks, 0), np.int64),
                                    True, req.produced, slot))
            if done:
                req.finished = True
                self._record_done(req)
                if self._slot_req[slot] is req:
                    # finished before its predicted budget: free the slot now
                    self._slot_req[slot] = None
                    if not eos:  # the device flag is not set: force it
                        budget_done.append(slot)
        eng.metrics.record_tokens(n_tokens)
        if budget_done:
            self._mark_done(budget_done)
        return events

    def reset(self) -> None:
        """Rebuild the pool after a failed ``step()``: drop every queued and
        live request (the caller has already failed their consumers), clear
        what is in flight, and reinstall a fresh all-done state."""
        with self._lock:
            dropped = list(self._queue)
            self._queue.clear()
            self._cancelled.clear()
        dropped += [r for r in self._slot_req if r is not None]
        for req in dropped:
            req.finished = True
            self._record_done(req)
        self._slot_req = [None] * self.slots
        self._pending = None
        self._dirty.clear()
        with self.on_stream():
            self._state = self._fresh_pool()
        self.allocs.append(self._alloc)
        logger.warning("serve: pool state rebuilt after step failure (%d request(s) dropped)",
                       len(dropped))

    def _record_done(self, req: _Request) -> None:
        now = time.monotonic()
        self._done_stats.append({
            "request_id": req.id,
            "frames": req.produced,
            "queue_wait_s": (req.t_admit or now) - req.t_submit,
            # consumer-visible time to first frames (queue wait included)
            "ttft_s": (req.t_first or now) - req.t_submit,
            "total_s": now - req.t_submit,
        })

    def stats(self) -> dict:
        """Serving stats over the last completed requests (window of 1024):
        p50/p95 queue wait and time to first frames, mean per-request frame
        rate, queue depth and live slots.  Host bookkeeping only."""
        with self._lock:
            depth = len(self._queue)
        recs = list(self._done_stats)
        out = {"completed": len(recs), "expired": self._n_expired, "queue_depth": depth,
               "live_slots": sum(r is not None for r in self._slot_req), "slots": self.slots}
        if recs:
            qw = np.sort([r["queue_wait_s"] for r in recs])
            tf = np.sort([r["ttft_s"] for r in recs])
            out["queue_wait_p50_s"] = float(np.percentile(qw, 50))
            out["queue_wait_p95_s"] = float(np.percentile(qw, 95))
            out["ttft_p50_s"] = float(np.percentile(tf, 50))
            out["ttft_p95_s"] = float(np.percentile(tf, 95))
            tot = sum(r["total_s"] for r in recs)
            out["frames_per_request_s"] = sum(r["frames"] for r in recs) / tot if tot else 0.0
        return out

    @property
    def busy(self) -> bool:
        with self._lock:
            q = bool(self._queue)
        return q or any(r is not None for r in self._slot_req) or self._pending is not None

    def run(self) -> Iterator[Event]:
        """Drive the scheduler until the queue and every slot drain."""
        while self.busy:
            yield from self.step()


class _RowNoise:
    """A host noise source over a batch's rows (CPU only): row b calls the
    source of the request ``reqs[b]`` as ``noise(0, step, draws)``, the
    slot it holds in a solo run; a free row draws zeros."""

    def __init__(self, reqs: list[_Request | None], cfg):
        self.reqs = reqs
        self._K1 = cfg.num_codebooks - 1

    def __call__(self, b: int, step: int, d: decode_mod.Draws):
        req = self.reqs[b]
        if req is None:
            return torch.zeros(d.slow), torch.zeros(self._K1, d.fast)
        if req.noise is None:
            raise ValueError("requests with and without a host noise source cannot share a "
                             "pool")
        return req.noise(0, step, d)
