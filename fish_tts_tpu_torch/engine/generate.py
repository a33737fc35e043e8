"""Generation loop: port of ``fish_tts_tpu/engine/generate.py`` for
non-streaming single-stream generation.

``GenerationEngine.generate_long`` builds the prompt, right-pads it to the
smallest configured bucket, sizes the KV-cache allocation, runs prefill
plus the first chunk, then decode chunks of ``batch_chunk`` frames until
EOS or the token budget, and yields the codes with the final frame
stripped (the reference's batch-mode quirk).  The next chunk is launched
before the previous one is read back, so the host enqueues work while the
device runs.

The engine keeps one decode state per (batch, cache allocation) and resets
it in place for each generation.  On the card every decode frame after
prefill is a replay of a :class:`~fish_tts_tpu_torch.engine.decode.DecodeGraph`
captured on that state, one per (batch, cache rows, read rows, window,
dtype, skip, route); on the CPU the same frame runs eagerly.  The route
follows ``EngineConfig.sample_top_k``, ``approx_top_k`` and ``fast_kernel``
through the reference's per-call gates (``decode.route``); the engine logs
once when an option turns a kernel off.  ``metrics`` times
the host-visible fetch of each chunk ("prefill" for the first, "decode"
after) and counts the tokens, as the JAX engine does.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from fish_tts_tpu_torch.config import DualARConfig, EngineConfig
from fish_tts_tpu_torch.engine import decode as decode_mod
from fish_tts_tpu_torch.models.dual_ar import Params, TokenIds, make_rope_tables
from fish_tts_tpu_torch.models.prompt import build_prompt
from fish_tts_tpu_torch.models.tokenizer import FishTokenizer
from fish_tts_tpu_torch.utils.profiling import Metrics

logger = logging.getLogger(__name__)


@dataclass
class GenerateResponse:
    action: str  # "sample" | "next"
    codes: np.ndarray | None = None  # (num_codebooks, n): vocoder rows only
    text: str | None = None


def _pick_bucket(buckets: tuple[int, ...], n: int, cap: int) -> int:
    for b in buckets:
        if n <= b <= cap:
            return b
    if n <= cap:
        return cap
    raise ValueError(f"Prompt length {n} exceeds maximum {cap}")


def _kv_bucket(n: int, step: int, cap: int) -> int:
    """Smallest multiple of ``step`` >= n, capped at the cache length."""
    return min(cap, -(-n // step) * step)


CACHE_FLOOR = 512  # smallest KV-cache allocation, in rows


def _cache_bucket(n: int, cap: int) -> int:
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


def _start_fetch(frames: torch.Tensor, emitted: torch.Tensor):
    """Start a chunk's copy to the host right behind it in stream order, so
    that reading it back waits for this chunk alone, not for the chunk
    dispatched after it.  Returns (frames, emitted, the copy's CUDA event,
    None on the CPU)."""
    if frames.device.type != "cuda":
        return frames, emitted, None
    out = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)
           for t in (frames, emitted)]
    copied = torch.cuda.Event()
    copied.record()
    return out[0], out[1], copied


class GenerationEngine:
    """Runs prefill and chunked decode from the host on the parameters' device."""

    def __init__(self, params: Params, cfg: DualARConfig, tokenizer: FishTokenizer,
                 engine_cfg: EngineConfig | None = None, seed: int = 0):
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.engine_cfg = engine_cfg or EngineConfig()
        self.device = params["norm"].device
        self.ids = TokenIds(
            semantic_begin=tokenizer.semantic_begin_id,
            semantic_end=tokenizer.semantic_end_id,
            im_end=tokenizer.im_end_id,
        )
        self.rope = make_rope_tables(cfg, device=self.device)
        ecfg = self.engine_cfg
        self._options = dict(top_k=ecfg.sample_top_k, approx=ecfg.approx_top_k,
                             fast_kernel=ecfg.fast_kernel)
        window = ecfg.rep_penalty_window
        kernels_on = decode_mod.route(cfg, params, 1, window)
        chosen = decode_mod.route(cfg, params, 1, window, **self._options)
        off = [name for name in ("slow_stack", "sampler", "fast")
               if getattr(kernels_on, name) and not getattr(chosen, name)]
        if off:
            logger.info("sample_top_k=%d, fast_kernel=%s turn off the %s kernel(s): those "
                        "parts run on plain PyTorch", ecfg.sample_top_k, ecfg.fast_kernel,
                        ", ".join(off))
        self._seeds = np.random.default_rng(seed)
        self.metrics = Metrics()
        self._states: dict[tuple, decode_mod.State] = {}
        self._graphs: dict[tuple, decode_mod.DecodeGraph] = {}

    def _next_noise(self) -> decode_mod.GumbelNoise:
        """A fresh noise source for one generation."""
        seed = int(self._seeds.integers(0, 2**63 - 1))
        return decode_mod.GumbelNoise(seed, self.cfg, self.device)

    @property
    def _large_chunk(self) -> int:
        return max(self.engine_cfg.batch_chunk, self.engine_cfg.decode_chunk)

    def _fresh_state(self, batch: int, alloc: int) -> decode_mod.State:
        """The persistent state of (batch, alloc), reset in place."""
        state = self._states.get((batch, alloc))
        if state is None:
            state = self._states[(batch, alloc)] = decode_mod.init_state(
                self.params, self.cfg, batch=batch, max_seq_len=alloc,
                window=self.engine_cfg.rep_penalty_window)
            return state
        return decode_mod.reset_state(state)

    def _decode(self, state: decode_mod.State, noise, sampling, num_frames: int,
                kv_bucket: int, early_exit: bool):
        """``num_frames`` decode frames: graph replays on the card, the
        eager loop on the CPU.  Returns (frames, emitted) on the device."""
        if self.device.type != "cuda":
            _, frames, emitted = decode_mod.decode_chunk(
                self.params, self.rope, state, noise, *sampling, cfg=self.cfg, ids=self.ids,
                num_frames=num_frames, kv_bucket=kv_bucket, early_exit=early_exit,
                **self._options)
            return frames, emitted
        B, W = state["frame"].shape[0], state["prev"].shape[2]
        skip_done = B > 1 or early_exit
        key = (B, state["kv"]["k"].shape[3], kv_bucket, W, state["kv"]["k"].dtype, skip_done,
               decode_mod.route(self.cfg, self.params, B, W, **self._options))
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._graphs[key] = decode_mod.DecodeGraph(
                self.params, self.cfg, self.ids, self.rope, state, kv_bucket=kv_bucket,
                skip_done=skip_done, capacity=self._large_chunk, **self._options)
        return graph.run(num_frames)

    def _pad_prompt(self, values: np.ndarray) -> tuple[np.ndarray, int]:
        """Right-pad a (1+K, T) prompt to the smallest bucket (zeros)."""
        T = values.shape[1]
        if T == 0:
            raise ValueError("Empty prompt")
        bucket = _pick_bucket(self.engine_cfg.prompt_buckets, T, self.cfg.max_seq_len - 1)
        padded = np.zeros((1, values.shape[0], bucket), np.int32)
        padded[0, :, :T] = values
        return padded, T

    def generate_long(self, text: str, *, num_samples: int = 1, max_new_tokens: int = 0,
                      top_p: float = 0.8, repetition_penalty: float = 1.1,
                      temperature: float = 0.8, prompt_text: list[str] | None = None,
                      prompt_tokens: list[np.ndarray] | None = None,
                      noise=None) -> Iterator[GenerateResponse]:
        """Generate vocoder codes for ``text``: one ``"sample"`` with all codes
        (final frame stripped) then a ``"next"``, per sample.  ``noise``
        replaces the engine's own noise source (one per sample otherwise);
        on the card it must be a ``GumbelNoise``, drawn inside the graph."""
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
            yield self._generate_one(
                text, max_new_tokens=max_new_tokens, top_p=top_p,
                repetition_penalty=repetition_penalty, temperature=temperature,
                prompt_text=prompt_text or [], prompt_tokens=prompt_tokens or [],
                noise=noise or self._next_noise())
            yield GenerateResponse(action="next")

    def _generate_one(self, text: str, *, max_new_tokens: int, top_p: float,
                      repetition_penalty: float, temperature: float,
                      prompt_text: list[str], prompt_tokens: list[np.ndarray],
                      noise) -> GenerateResponse:
        cfg, ecfg, ids = self.cfg, self.engine_cfg, self.ids
        max_length = cfg.max_seq_len
        enc = build_prompt(self.tokenizer, text, cfg.num_codebooks,
                           prompt_texts=prompt_text, prompt_codes=prompt_tokens)
        prompt_len = enc.values.shape[1]
        reserve = min(2048, max_length // 2)
        if prompt_len > max_length - reserve:
            raise ValueError(f"Prompt is too long: {prompt_len} > {max_length - reserve}")
        max_new = max_length - prompt_len
        if max_new_tokens:
            max_new = min(max_new_tokens, max_new)

        padded, T = self._pad_prompt(enc.values)
        alloc = _cache_bucket(max(prompt_len + max_new + 2 * self._large_chunk,
                                  padded.shape[-1] + 1), max_length)
        state = self._fresh_state(1, alloc)
        sampling = (temperature, top_p, repetition_penalty)

        # prefill (it loads the sampling parameters and noise keys into the
        # state) + the first chunk, straight-line; n0 == 0 when the prefill
        # frame fills the budget
        n0 = max(0, min(ecfg.first_chunk - 1, ecfg.decode_chunk, max_new - 1))
        _, first = decode_mod.prefill(
            self.params, self.rope, state, torch.as_tensor(padded, device=self.device),
            torch.tensor([T], dtype=torch.int32, device=self.device), noise, *sampling,
            cfg=cfg, ids=ids, kv_bucket=0, **self._options)
        frames, emitted = first[:, None], torch.ones((1, 1), dtype=torch.bool,
                                                      device=self.device)
        if n0:
            f1, e1 = self._decode(state, noise, sampling, n0, min(alloc, _kv_bucket(
                prompt_len + n0, ecfg.kv_bucket_step, max_length)), early_exit=False)
            frames, emitted = torch.cat([frames, f1], dim=1), torch.cat([emitted, e1], dim=1)

        dispatched = 1 + n0
        pending = (*_start_fetch(frames, emitted), True)
        produced = 0
        collected: list[np.ndarray] = []
        chunk = self._large_chunk
        while pending is not None:
            frames_host, emitted_host, copied, is_first = pending
            nxt = None
            if dispatched < max_new:
                # launch the next chunk before reading this one back
                n = _chunk_len(max_new - dispatched, chunk, ecfg.decode_chunk)
                f2, e2 = self._decode(state, noise, sampling, n, min(alloc, _kv_bucket(
                    prompt_len + dispatched + n, ecfg.kv_bucket_step, max_length)),
                    early_exit=True)
                nxt = (*_start_fetch(f2, e2), False)
                dispatched += n
            with self.metrics.span("prefill" if is_first else "decode"):
                if copied is not None:
                    copied.synchronize()
                frames_np = frames_host.numpy()  # (1, m, 1+K)
                emitted_np = emitted_host.numpy()[0]
            done = bool((not emitted_np[-1]) or frames_np[0, -1, 0] == ids.im_end)
            self.metrics.record_tokens(int(min(emitted_np.sum(), max_new - produced)))
            valid = frames_np[:, emitted_np][:, :max_new - produced]
            produced += valid.shape[1]
            if valid.shape[1]:
                collected.append(valid)
            pending = None if (done or produced >= max_new) else nxt

        all_frames = np.concatenate(collected, axis=1)[0]  # (n, 1+K)
        # the final frame is stripped, EOS or not (reference quirk)
        codes = all_frames[:-1, 1:].T if all_frames.shape[0] > 1 else all_frames[:0, 1:].T
        codes = np.maximum(codes, 0)
        return GenerateResponse(action="sample", codes=codes.astype(np.int64), text=text)
