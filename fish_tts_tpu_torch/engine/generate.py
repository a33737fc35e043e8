"""Generation loop: port of ``fish_tts_tpu/engine/generate.py``:
single-stream and batched generation, streamed or not, with the
reference-voice KV prefix.

``GenerationEngine.generate_long`` builds the prompt, right-pads it to the
smallest configured bucket, sizes the KV-cache allocation, runs prefill
plus the first chunk, then decode chunks until EOS or the token budget.
Non-streaming it decodes ``batch_chunk`` frames a call and yields the codes
once, with the final frame stripped (the reference's batch-mode quirk);
streaming it decodes ``decode_chunk`` frames a call and yields every chunk
as it lands, the EOS frame included.  The next chunk is launched before
the previous one is read back, so the host enqueues work while the device
runs.

``set_prefix`` prefills the reference blocks once into a state of the
engine's own; a later call without references forks it (copies it into
the call's persistent state, in place, broadcast over a batch's rows) and
prefills only the target text at the prefix's offset.

``generate_batch`` / ``generate_batch_stream`` decode several texts in
one (B, alloc) state (``_batch_chunks``): the streams are grouped by prompt
bucket, each group prefills into its own rows of that state in place (a
view of the rows, so the decode graphs captured on the state see it), and
the recombined batch decodes in grouped row order with per-stream
sampling columns and budgets; rows go back to the caller's order on the
host.

The engine's :class:`~fish_tts_tpu_torch.engine.decode.Runner` holds its
decode states, one per (batch, cache allocation), reset in place for each
generation, and runs every decode chunk and ``generate_long``'s prefill on
them: graph replays on the card (one decode graph per state, read rows and
skip; one prefill graph per state, prompt bucket and prefix read rows),
the eager loop on the CPU and on a mesh.  ``set_prefix``'s one-off prefill
and a batch's grouped prefills (row views) call the eager prefill
themselves.  A serving pool takes a runner of its own
(``engine.runner.sibling``).  The route follows ``EngineConfig.sample_top_k``,
``approx_top_k`` and ``fast_kernel`` through the reference's per-call gates
(``decode.route``); the engine logs once when an option turns a kernel off.

``EngineConfig(tp_size, dp_size)`` with a product above 1 puts the engine
on a (dp, tp) mesh (``parallel/mesh.py``) over ``devices`` (default: every
visible card; on the CPU, tp * dp handles to the CPU): the parameters are
sharded once (``parallel.sharding.shard_params``), the states' caches over
(dp rows of the batch, tp KV heads), and the mesh route of
``models/dual_ar.py`` runs.  As in the JAX package, no kernel runs on a
mesh and every cache is allocated at the full context, never resized; decode
runs the eager loop (a frame spans devices, so no graph is captured).
``metrics`` times
the host-visible fetch of each chunk ("prefill" for the first, "decode"
after) and counts the tokens, as the JAX engine does.  A ``generate_long``
sample also records, under a per-call id, the spans ``engine.prompt``
(encode and pad), ``engine.prefill.launch`` (the state, the prefill and the
first chunk's launch) and ``engine.decode.launch`` (each later chunk), and
the request span ``engine.first_frames``, from the call's start to the host
holding its first frames; a decode or prefill graph's capture is a
``graph.capture`` span.
"""

from __future__ import annotations

import itertools
import logging
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from fish_tts_tpu_torch.config import DualARConfig, EngineConfig
from fish_tts_tpu_torch.engine import decode as decode_mod
from fish_tts_tpu_torch.models.dual_ar import Params, TokenIds, make_rope_tables
from fish_tts_tpu_torch.models.prompt import ContentSequence, TextPart, VQPart, build_prompt
from fish_tts_tpu_torch.models.tokenizer import FishTokenizer
from fish_tts_tpu_torch.parallel import sharding
from fish_tts_tpu_torch.parallel.mesh import make_mesh
from fish_tts_tpu_torch.utils import profiling
from fish_tts_tpu_torch.utils.profiling import Metrics

logger = logging.getLogger(__name__)


@dataclass
class GenerateResponse:
    action: str  # "sample" | "next"
    codes: np.ndarray | None = None  # (num_codebooks, n): vocoder rows only
    text: str | None = None


def pick_bucket(buckets: tuple[int, ...], n: int, cap: int) -> int:
    for b in buckets:
        if n <= b <= cap:
            return b
    if n <= cap:
        return cap
    raise ValueError(f"Prompt length {n} exceeds maximum {cap}")


def kv_bucket(n: int, step: int, cap: int) -> int:
    """Smallest multiple of ``step`` >= n, capped at the cache length."""
    return min(cap, -(-n // step) * step)


CACHE_FLOOR = 512  # smallest KV-cache allocation, in rows


def cache_bucket(n: int, cap: int) -> int:
    """Smallest power-of-two allocation >= n (>= CACHE_FLOOR), capped."""
    b = min(CACHE_FLOOR, cap)
    while b < min(n, cap):
        b *= 2
    return min(b, cap)


def _chunk_len(remaining: int, chunk: int, decode_chunk: int) -> int:
    """Frames for the next decode call: a full ``chunk``, or the remainder
    rounded up to a ``decode_chunk`` multiple.  The overshoot stays safe
    because decode clamps ``pos`` to the cache end and the host truncates to
    the budget."""
    if remaining >= chunk:
        return chunk
    return max(decode_chunk, -(-remaining // decode_chunk) * decode_chunk)


def start_fetch(*tensors: torch.Tensor):
    """Start copies of ``tensors`` to the host right behind them in stream
    order, so that reading one back waits for its own work alone, not for
    the work dispatched after it.  Returns (*the host tensors, the copies'
    CUDA event, None on the CPU)."""
    if tensors[0].device.type != "cuda":
        return (*tensors, None)
    out = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)
           for t in tensors]
    copied = torch.cuda.Event()
    copied.record()
    return (*out, copied)


def to_device_async(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without waiting for the work queued there:
    a blocking copy from pageable memory would wait for it (an LM chunk
    already launched, a group's prefill)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _per_stream(x, B: int, name: str, ok) -> np.ndarray:
    """A sampling parameter as (B,) float32: one shared scalar or one value
    per text, each in range."""
    arr = (np.full(B, float(x), np.float32) if np.isscalar(x)
           else np.asarray(x, np.float32))
    if arr.shape != (B,):
        raise ValueError(f"{name} must be a scalar or one value per text")
    if not ok(arr).all():
        raise ValueError(f"{name} out of range")
    return arr


def _rows(state: decode_mod.State, a: int, b: int) -> decode_mod.State:
    """Views of the rows [a, b) of every tensor of ``state``: writes through
    them land in the state's own memory."""
    return {k: ({kk: vv.narrow(1, a, b - a) for kk, vv in v.items()} if k == "kv"
                else v[:, a:b] if k == "sampling" else v[a:b])
            for k, v in state.items()}


def _kernels_off(on: decode_mod.Route, chosen: decode_mod.Route) -> list[str]:
    return [name for name in ("slow_stack", "sampler", "fast")
            if getattr(on, name) and not getattr(chosen, name)]


class GenerationEngine:
    """Runs prefill and chunked decode from the host on the parameters'
    device, or on a (dp, tp) mesh over ``devices`` (see the module
    docstring)."""

    def __init__(self, params: Params, cfg: DualARConfig, tokenizer: FishTokenizer,
                 engine_cfg: EngineConfig | None = None, seed: int = 0,
                 devices: list | None = None):
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.engine_cfg = ecfg = engine_cfg or EngineConfig()
        self.mesh = None
        if ecfg.tp_size * ecfg.dp_size > 1:
            if devices is None and params["norm"].device.type == "cpu":
                devices = [params["norm"].device] * (ecfg.tp_size * ecfg.dp_size)
            self.mesh = make_mesh(tp=ecfg.tp_size, dp=ecfg.dp_size, devices=devices)
            params = sharding.shard_params(params, cfg, self.mesh)
            logger.info("LM sharded over mesh(dp=%d, tp=%d): the kernels are off, decode "
                        "runs the eager loop", ecfg.dp_size, ecfg.tp_size)
        elif devices is not None:
            raise ValueError("devices= needs EngineConfig(tp_size * dp_size > 1)")
        self.params = params
        self.device = params["norm"].device
        self.ids = TokenIds(
            semantic_begin=tokenizer.semantic_begin_id,
            semantic_end=tokenizer.semantic_end_id,
            im_end=tokenizer.im_end_id,
        )
        self.rope = make_rope_tables(cfg, device=self.device)
        if self.mesh is not None:
            self.rope = sharding.shard_rope(self.rope, self.mesh)
        self.metrics = Metrics()
        # generate_long's prefills and every decode chunk; the kernels are
        # single-device programs: a mesh turns them off
        self.runner = decode_mod.Runner(
            params, cfg, self.ids, self.rope, self.metrics, capacity=self._large_chunk,
            window=ecfg.rep_penalty_window, top_k=ecfg.sample_top_k, approx=ecfg.approx_top_k,
            fast_kernel=ecfg.fast_kernel and self.mesh is None)
        off = _kernels_off(decode_mod.route(cfg, params, 1, ecfg.rep_penalty_window),
                           self.runner.route(1))
        if off:
            logger.info("sample_top_k=%d, fast_kernel=%s turn off the %s kernel(s): those "
                        "parts run on plain PyTorch", ecfg.sample_top_k, ecfg.fast_kernel,
                        ", ".join(off))
        self._batch_gate_logged = False
        self._seeds = np.random.default_rng(seed)
        self._seeds_lock = threading.Lock()
        self._calls = itertools.count()  # the ids of generate_long's samples
        # The reference-voice prefix: (state, generation, length in tokens),
        # replaced whole on each change so that a caller takes a consistent
        # snapshot with one attribute read.  The state is the engine's own
        # allocation, never a call's working state.
        self._prefix_counter = itertools.count(1)
        self._prefix_ref: tuple[decode_mod.State | None, int, int] = (None, 0, 0)

    def next_noise(self) -> decode_mod.GumbelNoise:
        """A fresh noise source for one generation."""
        with self._seeds_lock:
            seed = int(self._seeds.integers(0, 2**63 - 1))
        return decode_mod.GumbelNoise(seed, self.cfg, self.device)

    def seed_noise(self, seed: int) -> decode_mod.GumbelNoise:
        """The source that the first generation after ``reseed(seed)``
        draws, leaving the engine's own sequence as it is."""
        return decode_mod.GumbelNoise(int(np.random.default_rng(seed).integers(0, 2**63 - 1)),
                                      self.cfg, self.device)

    def reseed(self, seed: int) -> None:
        """Restart the sequence of per-generation noise seeds from ``seed``."""
        with self._seeds_lock:
            self._seeds = np.random.default_rng(seed)

    # -- the reference-voice prefix --------------------------------------

    def set_prefix(self, prompt_texts: list[str], prompt_codes: list[np.ndarray]) -> None:
        """Prefill the reference blocks once; later calls without references
        start from here.  The prefix is the prompt up to the final
        [speaker, target text] block of the reference layout.  No texts
        clears it."""
        if not prompt_texts:
            self.clear_prefix()
            return
        seq = ContentSequence(modality="interleave")
        for t, c in zip(prompt_texts, prompt_codes):
            seq.append([TextPart(text=t), VQPart(codes=c)], add_end=True, speaker=0)
        enc = seq.encode_for_inference(self.tokenizer, self.cfg.num_codebooks)
        padded, T = self._pad_prompt(enc.values)
        state = decode_mod.init_state(self.params, self.cfg, batch=1,
                                      window=self.engine_cfg.rep_penalty_window)
        # the frame sampled off the prefix is discarded; a throwaway noise
        # source leaves the per-call seed sequence as it was
        decode_mod.prefill(
            self.params, self.rope, state, torch.as_tensor(padded, device=self.device),
            torch.tensor([T], dtype=torch.int32, device=self.device),
            decode_mod.GumbelNoise(0, self.cfg), 0.7, 0.8, 1.1, cfg=self.cfg, ids=self.ids,
            kv_bucket=0, **self.runner.options)
        # only the KV cache and the position survive
        for k in ("done", "frame", "step"):
            state[k].zero_()
        # the length is published with the state, so that a reader of the
        # snapshot never reads it back from the device
        self._prefix_ref = (state, next(self._prefix_counter), T)
        logger.info("Cached KV prefix of %d tokens for %d reference(s)", T, len(prompt_texts))

    def clear_prefix(self) -> None:
        self._prefix_ref = (None, next(self._prefix_counter), 0)

    @property
    def _prefix_state(self) -> decode_mod.State | None:
        return self._prefix_ref[0]

    def prefix_snapshot(self) -> tuple[decode_mod.State | None, int, int]:
        """One consistent (prefix state, its generation, its length in
        tokens; 0 without a prefix): one read of the published tuple."""
        return self._prefix_ref

    @property
    def has_prefix(self) -> bool:
        return self._prefix_ref[0] is not None

    def _fork_prefix(self, prefix: decode_mod.State, alloc: int,
                     batch: int = 1) -> decode_mod.State:
        """Copy a B = 1 prefix snapshot into every row of the persistent
        state of (batch, alloc), in place (a captured decode graph holds
        that state's addresses): the KV rows below ``min(S_prefix, alloc)``
        (the rest zero), then every other field, broadcast over the rows.
        The caller passes the one snapshot it gated on.  The JAX package's
        ``_fork_prefix`` and ``_fork_prefix_batch`` in one."""
        return self.fork_into(prefix, self.runner.state(batch, alloc))

    def fork_into(self, prefix: decode_mod.State, state: decode_mod.State) -> decode_mod.State:
        """Copy a B = 1 prefix snapshot into a zeroed ``state`` in place: its
        KV rows, then every other field, broadcast over the rows."""
        self._fork_kv(prefix["kv"], state["kv"])
        for k, v in prefix.items():
            if k != "kv":
                state[k].copy_(v)
        return state

    @staticmethod
    def _fork_kv(src: dict, dst: dict) -> None:
        """Copy a prefix KV into a zeroed allocation of another size and
        batch: sliced when smaller (only dead rows drop: callers size it
        above the prefix extent), zero-padded when larger, its one row
        broadcast over the batch."""
        n = min(src["k"].shape[3], dst["k"].shape[3])
        for k in ("k", "v"):
            dst[k].narrow(3, 0, n).copy_(src[k].narrow(3, 0, n))

    def encode_suffix(self, text: str):
        """Encode only the target-text block, the part of the reference
        layout after the cached prefix."""
        seq = ContentSequence(modality=None)
        seq.append([TextPart(text=text)], add_end=False, speaker=0)
        return seq.encode_for_inference(self.tokenizer, self.cfg.num_codebooks)

    @property
    def _large_chunk(self) -> int:
        return max(self.engine_cfg.batch_chunk, self.engine_cfg.decode_chunk)

    def alloc_rows(self, n: int) -> int:
        """The cache allocation for a worst-case extent of ``n`` rows: its
        power-of-two bucket, or the full context on a mesh, whose caches are
        never resized (JAX ``generate.py:287-300``)."""
        if self.mesh is not None:
            return self.cfg.max_seq_len
        return cache_bucket(n, self.cfg.max_seq_len)

    def _pad_prompt(self, values: np.ndarray) -> tuple[np.ndarray, int]:
        """Right-pad a (1+K, T) prompt to the smallest bucket (zeros)."""
        T = values.shape[1]
        if T == 0:
            raise ValueError("Empty prompt")
        bucket = pick_bucket(self.engine_cfg.prompt_buckets, T, self.cfg.max_seq_len - 1)
        padded = np.zeros((1, values.shape[0], bucket), np.int32)
        padded[0, :, :T] = values
        return padded, T

    def generate_long(self, text: str, *, num_samples: int = 1, max_new_tokens: int = 0,
                      top_p: float = 0.8, repetition_penalty: float = 1.1,
                      temperature: float = 0.8, prompt_text: list[str] | None = None,
                      prompt_tokens: list[np.ndarray] | None = None, streaming: bool = False,
                      use_prefix_cache: bool = True, show_progress: bool = False,
                      noise=None) -> Iterator[GenerateResponse]:
        """Generate vocoder codes for ``text``, per sample: non-streaming one
        ``"sample"`` with all codes (final frame stripped), streaming one
        ``"sample"`` per decoded chunk (the EOS frame included); then a
        ``"next"``.  With ``use_prefix_cache`` and no ``prompt_text`` a
        prefix set by :meth:`set_prefix` is forked and only the text is
        prefilled.  ``show_progress`` logs each chunk.  ``noise`` replaces
        the engine's own noise source (one per sample otherwise); on the
        card it must be a ``GumbelNoise``, drawn inside the graph."""
        if not 0 < top_p <= 1:
            raise ValueError("top_p must be in (0, 1]")
        if not 0 < repetition_penalty < 2:
            raise ValueError("repetition_penalty must be in (0, 2)")
        if not 0 < temperature < 2:
            raise ValueError("temperature must be in (0, 2)")
        if (noise is not None and self.device.type == "cuda"
                and not isinstance(noise, decode_mod.GumbelNoise)):
            raise TypeError("on a CUDA device the noise is drawn inside the decode graph: "
                            "pass a GumbelNoise")
        for _ in range(num_samples):
            yield from self._generate_one(
                text, max_new_tokens=max_new_tokens, top_p=top_p,
                repetition_penalty=repetition_penalty, temperature=temperature,
                prompt_text=prompt_text or [], prompt_tokens=prompt_tokens or [],
                streaming=streaming, use_prefix_cache=use_prefix_cache,
                show_progress=show_progress, noise=noise or self.next_noise())
            yield GenerateResponse(action="next")

    def _generate_one(self, text: str, *, max_new_tokens: int, top_p: float,
                      repetition_penalty: float, temperature: float,
                      prompt_text: list[str], prompt_tokens: list[np.ndarray],
                      streaming: bool, use_prefix_cache: bool, show_progress: bool,
                      noise) -> Iterator[GenerateResponse]:
        """One sample of ``generate_long``, without the trailing "next"."""
        t_call, rid = profiling.now(), next(self._calls)
        cfg, ecfg, ids = self.cfg, self.engine_cfg, self.ids
        max_length = cfg.max_seq_len
        with self.metrics.span("engine.prompt", rid=rid):
            # one snapshot: a later set_prefix/clear_prefix does not change what
            # this call forks
            prefix, _, snap_len = self.prefix_snapshot()
            use_cached_prefix = use_prefix_cache and prefix is not None and not prompt_text
            if use_cached_prefix:
                enc = self.encode_suffix(text)
                prefix_len = snap_len
                prompt_len = prefix_len + enc.values.shape[1]
            else:
                enc = build_prompt(self.tokenizer, text, cfg.num_codebooks,
                                   prompt_texts=prompt_text, prompt_codes=prompt_tokens)
                prefix_len, prompt_len = 0, enc.values.shape[1]
            reserve = min(2048, max_length // 2)
            if prompt_len > max_length - reserve:
                raise ValueError(f"Prompt is too long: {prompt_len} > {max_length - reserve}")
            max_new = max_length - prompt_len
            if max_new_tokens:
                max_new = min(max_new_tokens, max_new)

            padded, T = self._pad_prompt(enc.values)
            # the worst-case decode extent, and never below the padded prefill's
            # write extent
            alloc = self.alloc_rows(max(prompt_len + max_new + 2 * self._large_chunk,
                                        prefix_len + padded.shape[-1] + 1))
        sampling = (temperature, top_p, repetition_penalty)

        # prefill (it loads the sampling parameters and noise keys into the
        # state) + the first chunk, straight-line; n0 == 0 when the prefill
        # frame fills the budget
        n0 = max(0, min(ecfg.first_chunk - 1, ecfg.decode_chunk, max_new - 1))
        with self.metrics.span("engine.prefill.launch", kind="launch", rid=rid):
            state = (self._fork_prefix(prefix, alloc) if use_cached_prefix
                     else self.runner.state(1, alloc))
            kv_pre = kv_bucket(prefix_len, ecfg.kv_bucket_step, max_length) if prefix_len else 0
            _, first = self.runner.prefill(
                state, torch.as_tensor(padded, device=self.device),
                torch.tensor([T], dtype=torch.int32, device=self.device), noise, *sampling,
                kv_bucket=kv_pre)
            frames, emitted = first[:, None], torch.ones((1, 1), dtype=torch.bool,
                                                          device=self.device)
            if n0:
                f1, e1 = self.runner.decode(state, noise, sampling, n0, kv_bucket=min(
                    alloc, kv_bucket(prompt_len + n0, ecfg.kv_bucket_step, max_length)),
                    skip_done=False)
                frames, emitted = (torch.cat([frames, f1], dim=1),
                                   torch.cat([emitted, e1], dim=1))
            pending = (*start_fetch(frames, emitted), True)

        dispatched = 1 + n0
        produced = 0
        collected: list[np.ndarray] = []
        # streaming keeps small chunks, each a vocoder input; otherwise as
        # few read-backs as possible
        chunk = ecfg.decode_chunk if streaming else self._large_chunk
        while pending is not None:
            frames_host, emitted_host, copied, is_first = pending
            nxt = None
            if dispatched < max_new:
                # launch the next chunk before reading this one back
                n = _chunk_len(max_new - dispatched, chunk, ecfg.decode_chunk)
                with self.metrics.span("engine.decode.launch", kind="launch", rid=rid):
                    f2, e2 = self.runner.decode(state, noise, sampling, n, kv_bucket=min(
                        alloc, kv_bucket(prompt_len + dispatched + n, ecfg.kv_bucket_step,
                                         max_length)), skip_done=not streaming)
                    nxt = (*start_fetch(f2, e2), False)
                dispatched += n
            with self.metrics.span("prefill" if is_first else "decode", kind="wait", rid=rid):
                if copied is not None:
                    copied.synchronize()
                frames_np = frames_host.numpy()  # (1, m, 1+K)
                emitted_np = emitted_host.numpy()[0]
            if is_first:
                self.metrics.record("engine.first_frames", t_call, profiling.now(), rid=rid)
            done = bool((not emitted_np[-1]) or frames_np[0, -1, 0] == ids.im_end)
            self.metrics.record_tokens(int(min(emitted_np.sum(), max_new - produced)))
            if show_progress and not is_first:
                logger.info("decoded %d/%d frames%s", produced + int(emitted_np.sum()),
                            max_new, " (EOS)" if done else "")
            valid = frames_np[:, emitted_np][:, :max_new - produced]
            produced += valid.shape[1]
            if valid.shape[1]:
                collected.append(valid)
                if streaming:
                    codes = np.maximum(valid[0, :, 1:], 0)
                    yield GenerateResponse(action="sample", codes=codes.T.astype(np.int64),
                                           text=text)
            pending = None if (done or produced >= max_new) else nxt

        if not streaming:
            all_frames = np.concatenate(collected, axis=1)[0]  # (n, 1+K)
            # the final frame is stripped, EOS or not (reference quirk)
            codes = all_frames[:-1, 1:].T if all_frames.shape[0] > 1 else all_frames[:0, 1:].T
            codes = np.maximum(codes, 0)
            yield GenerateResponse(action="sample", codes=codes.astype(np.int64), text=text)

    # -- batched generation ------------------------------------------------

    def generate_batch(self, texts: list[str], *, max_new_tokens: int = 0,
                       top_p: float | list[float] = 0.8,
                       repetition_penalty: float | list[float] = 1.1,
                       temperature: float | list[float] = 0.8,
                       prompt_text: list[str] | None = None,
                       prompt_tokens: list[np.ndarray] | None = None,
                       use_prefix_cache: bool = True) -> list[np.ndarray]:
        """Decode several texts in one batch (:meth:`_batch_chunks`) in large
        chunks.  Returns one ``(num_codebooks, n_b)`` code array per text,
        each stream's final frame stripped as in ``generate_long``."""
        frames_all, emitted_all = [], []
        for frames, emitted in self._batch_chunks(
                texts, max_new_tokens=max_new_tokens, top_p=top_p,
                repetition_penalty=repetition_penalty, temperature=temperature,
                prompt_text=prompt_text, prompt_tokens=prompt_tokens,
                use_prefix_cache=use_prefix_cache, chunk_frames=self._large_chunk):
            frames_all.append(frames)
            emitted_all.append(emitted)
        if not frames_all:
            return []
        frames = np.concatenate(frames_all, axis=1)  # (B, N, 1+K)
        emitted = np.concatenate(emitted_all, axis=1)  # (B, N)
        out = []
        for b in range(len(texts)):
            fb = frames[b, emitted[b]]  # (n_b, 1+K)
            codes = fb[:-1, 1:].T if fb.shape[0] > 1 else fb[:0, 1:].T
            out.append(np.maximum(codes, 0).astype(np.int64))
        return out

    def generate_batch_stream(self, texts: list[str], *, max_new_tokens: int = 0,
                              top_p: float | list[float] = 0.8,
                              repetition_penalty: float | list[float] = 1.1,
                              temperature: float | list[float] = 0.8,
                              prompt_text: list[str] | None = None,
                              prompt_tokens: list[np.ndarray] | None = None,
                              use_prefix_cache: bool = True
                              ) -> Iterator[list[np.ndarray | None]]:
        """The streamed :meth:`generate_batch`: per decoded chunk, one
        ``(num_codebooks, m_b)`` code array per stream, ``None`` for a stream
        that emitted nothing (past its EOS or budget); each stream's EOS
        frame included.  A chunk where no stream emitted is not yielded."""
        for frames, emitted in self._batch_chunks(
                texts, max_new_tokens=max_new_tokens, top_p=top_p,
                repetition_penalty=repetition_penalty, temperature=temperature,
                prompt_text=prompt_text, prompt_tokens=prompt_tokens,
                use_prefix_cache=use_prefix_cache):
            if not emitted.any():
                continue
            out: list[np.ndarray | None] = []
            for b in range(len(texts)):
                fb = frames[b, emitted[b]]  # (m_b, 1+K)
                out.append(np.maximum(fb[:, 1:], 0).astype(np.int64).T if fb.shape[0] else None)
            yield out

    def _bucket_groups(self, lengths: np.ndarray) -> list[tuple[int, list[int]]]:
        """The streams grouped by prompt bucket: (bucket, caller indices),
        buckets ascending, each group in caller order."""
        groups: dict[int, list[int]] = {}
        for i, n in enumerate(lengths):
            bucket = pick_bucket(self.engine_cfg.prompt_buckets, int(n), self.cfg.max_seq_len - 1)
            groups.setdefault(bucket, []).append(i)
        return sorted(groups.items())

    def _batch_chunks(self, texts: list[str], *, max_new_tokens: int = 0,
                      top_p: float | list[float] = 0.8,
                      repetition_penalty: float | list[float] = 1.1,
                      temperature: float | list[float] = 0.8,
                      prompt_text: list[str] | None = None,
                      prompt_tokens: list[np.ndarray] | None = None,
                      use_prefix_cache: bool = True, chunk_frames: int | None = None
                      ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """The batched decode: yields ``(frames (B, n, 1+K), emitted (B, n))``
        per chunk, rows in the caller's order.  All streams decode in the
        persistent (B, alloc) state; each stops at its own EOS or budget,
        and a frame after every stream is done is skipped on the device.

        - With a stored prefix and no explicit references, the prefix is
          forked into every row and only each text is prefilled.
        - Streams are grouped by prompt bucket; each group prefills at its
          own padded length into its rows of the state (grouped order), with
          a noise source of its own, slots local to the group.
        - Then one noise source for the decode, slots the grouped rows, and
          the chunk loop, chunk k+1 launched before chunk k is read back.
        - Sampling parameters take one shared scalar (the bit-exact
          single-parameter path) or one value per text ((B, 1) columns).
        - Each stream's budget is ``min(max_new_tokens, max_seq_len - its
          prompt)``, as in its solo run; its emitted flags are clamped to it.
        """
        if not texts:
            return
        B = len(texts)
        t_arr = _per_stream(temperature, B, "temperature", lambda a: (0 < a) & (a < 2))
        p_arr = _per_stream(top_p, B, "top_p", lambda a: (0 < a) & (a <= 1))
        r_arr = _per_stream(repetition_penalty, B, "repetition_penalty",
                            lambda a: (0 < a) & (a < 2))
        uniform = all((a == a[0]).all() for a in (t_arr, p_arr, r_arr))
        cfg, ecfg, ids = self.cfg, self.engine_cfg, self.ids

        # one snapshot: the prefix's length and the forked KV describe the
        # same prefix even if set_prefix/clear_prefix lands mid-call
        prefix, _, snap_len = self.prefix_snapshot()
        use_cached_prefix = use_prefix_cache and prefix is not None and not prompt_text
        if use_cached_prefix:
            encs = [self.encode_suffix(t) for t in texts]
            prefix_len = snap_len
        else:
            encs = [build_prompt(self.tokenizer, t, cfg.num_codebooks,
                                 prompt_texts=prompt_text or [],
                                 prompt_codes=prompt_tokens or []) for t in texts]
            prefix_len = 0
        lengths = np.array([e.values.shape[1] for e in encs], np.int64)
        prompt_lens = prefix_len + lengths
        reserve = min(2048, cfg.max_seq_len // 2)
        if prompt_lens.max() > cfg.max_seq_len - reserve:
            raise ValueError(f"Prompt is too long: {prompt_lens.max()} > "
                             f"{cfg.max_seq_len - reserve}")
        max_len = int(prompt_lens.max())
        budgets = cfg.max_seq_len - prompt_lens
        if max_new_tokens:
            budgets = np.minimum(max_new_tokens, budgets)
        max_new = int(budgets.max())

        def columns(idxs):
            if uniform:
                return float(t_arr[0]), float(p_arr[0]), float(r_arr[0])
            return tuple(to_device_async(a[idxs][:, None], self.device)
                         for a in (t_arr, p_arr, r_arr))

        off = _kernels_off(self.runner.route(1), self.runner.route(B))
        if off and not self._batch_gate_logged:
            self._batch_gate_logged = True
            logger.info("B=%d is past the batch limit of the %s kernel(s): those parts run "
                        "on plain PyTorch", B, ", ".join(off))

        groups = self._bucket_groups(lengths)
        order = [i for _, idxs in groups for i in idxs]  # grouped row -> caller index
        # the worst-case decode extent, never below a group's padded prefill
        alloc = self.alloc_rows(max(max_len + max_new + 2 * self._large_chunk,
                                    prefix_len + groups[-1][0] + 1))
        state = (self._fork_prefix(prefix, alloc, batch=B) if use_cached_prefix
                 else self.runner.state(B, alloc))
        kv_pre = kv_bucket(prefix_len, ecfg.kv_bucket_step, cfg.max_seq_len) if prefix_len else 0
        firsts, r0 = [], 0
        with self.metrics.span("prefill", kind="launch"):
            for bucket, idxs in groups:
                padded = np.zeros((len(idxs), 1 + cfg.num_codebooks, bucket), np.int32)
                for row, i in enumerate(idxs):
                    padded[row, :, :lengths[i]] = encs[i].values
                _, first = decode_mod.prefill(
                    self.params, self.rope, _rows(state, r0, r0 + len(idxs)),
                    to_device_async(padded, self.device),
                    to_device_async(lengths[idxs].astype(np.int32), self.device),
                    self.next_noise(), *columns(idxs), cfg=cfg, ids=ids, kv_bucket=kv_pre,
                    **self.runner.options)
                firsts.append(first)
                r0 += len(idxs)
        # the decode's own source and the columns in grouped row order,
        # loaded into the state the decode graphs read
        noise, sampling = self.next_noise(), columns(order)
        decode_mod.set_sampling(state, *sampling)
        decode_mod.set_noise(state, noise)

        inv = np.empty(B, np.int64)
        inv[order] = np.arange(B)
        budgets_g = budgets[order]
        chunk = chunk_frames or ecfg.decode_chunk

        def dispatch(dispatched: int):
            n = _chunk_len(max_new - dispatched, chunk, ecfg.decode_chunk)
            f, e = self.runner.decode(state, noise, sampling, n, kv_bucket=min(
                alloc, kv_bucket(max_len + dispatched + n, ecfg.kv_bucket_step,
                                 cfg.max_seq_len)), skip_done=True)
            return (*start_fetch(f, e), n)

        first_host, copied = start_fetch(torch.cat(firsts))
        dispatched, pending = 1, None
        if dispatched < max_new:
            pending = dispatch(dispatched)
            dispatched += pending[-1]
        if copied is not None:
            copied.synchronize()
        first_np = first_host.numpy()  # (B, 1+K), grouped order
        self.metrics.record_tokens(B)
        yield first_np[inv][:, None, :], np.ones((B, 1), bool)

        # done_rows lags one chunk behind: at most one chunk too many is
        # launched, and its frames are skipped on the device
        done_rows = (first_np[:, 0] == ids.im_end) | (budgets_g <= 1)
        produced = 1
        while True:
            nxt = None
            if dispatched < max_new and not done_rows.all():
                nxt = dispatch(dispatched)
                dispatched += nxt[-1]
            if pending is None and nxt is None:
                break
            if pending is not None:
                f_host, e_host, copied, n_disp = pending
                with self.metrics.span("decode", kind="wait"):
                    if copied is not None:
                        copied.synchronize()
                    f_np, e_np = f_host.numpy(), e_host.numpy()
                n = min(n_disp, max_new - produced)
                # each row clamped to its own budget: the columns past it are
                # over-decode, run for the streams with larger budgets
                e_np = e_np & (np.arange(n_disp)[None, :] < (budgets_g - produced)[:, None])
                produced += n
                done_rows = ((~e_np[:, -1]) | (f_np[:, -1, 0] == ids.im_end)
                             | (budgets_g <= produced))
                self.metrics.record_tokens(int(e_np[:, :n].sum()))
                yield f_np[inv][:, :n], e_np[inv][:, :n]
            pending = nxt
