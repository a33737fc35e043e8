"""The public API: ``FishTTS.synthesize(text) -> WAV bytes``,
``FishTTS.synthesize_stream(text) -> int16 PCM chunks``, their batched
forms ``synthesize_batch(texts)`` / ``synthesize_batch_stream(texts)``,
long text past one context, ``synthesize_long(text)`` /
``synthesize_long_stream(text)``, voice profiles from WAV audio,
``encode_reference(wav, text)``, and continuous-batching serving,
``FishTTS.serve() -> ServeSession``, on the card.

Port of ``fish_tts_tpu/synthesizer.py``: ``FishTTS`` (from a model
directory, native or the reference's ``model.pth``/``codec.pth``, or a
testing bundle, precision ``bf16`` by default, ``fp16``,
``fp32`` or ``int8``), single and batched synthesis, streamed or not, with
``references=`` per call or the stored ones (``set_references`` and
friends: prefilled once into the engine's KV prefix), long text in
sentence-aware chunks with a rolling carry of codes, the codec encoder
behind ``encode_reference``, the engine's ``metrics`` and
``get_metrics()``, ``VoiceProfile`` and the
``get_instance``/``reset_instance`` singleton.
A float precision casts the LM and the codec to that dtype (the KV cache
follows); ``int8`` keeps bf16 activations and codec with weight-only int8
LM matmuls, the route of the three kernels.
Entry points run on the card unless the caller asks for ``device="cpu"``;
``device="cuda"`` without a GPU raises.

Streaming pipelines the LM and the codec in CUDA stream order, with no
thread: a chunk's codec decode is enqueued, its copy to the host started,
and it is read back only after the next LM chunk has been requested.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterator, Literal

import numpy as np
import torch

from fish_tts_tpu_torch.config import DualARConfig, EngineConfig, VocoderConfig
from fish_tts_tpu_torch.engine.generate import GenerationEngine, start_fetch, to_device_async
from fish_tts_tpu_torch.models import vocoder, vocoder_stream
from fish_tts_tpu_torch.models.dual_ar import cast_params
from fish_tts_tpu_torch.models.tokenizer import FishTokenizer
from fish_tts_tpu_torch.utils import checkpoint as ckpt
from fish_tts_tpu_torch.utils.audio import read_wav, to_pcm_bytes, to_wav_bytes
from fish_tts_tpu_torch.utils.profiling import hbm_bytes_in_use
from fish_tts_tpu_torch.utils.quantize import quantize_lm_params
from fish_tts_tpu_torch.utils.text import split_text

logger = logging.getLogger(__name__)

_instance: "FishTTS | None" = None
_instance_lock = threading.Lock()

# Vocoder length buckets (frames); beyond the list they keep doubling.
_VOCODER_BUCKETS = (10, 20, 40, 80, 160, 320, 640, 1280, 2048)

PRECISIONS = ("bf16", "fp16", "fp32", "int8")
_DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16, "fp32": torch.float32,
           "int8": torch.bfloat16}


def _vocoder_bucket(n: int) -> int:
    """Smallest decode bucket >= n frames."""
    for b in _VOCODER_BUCKETS:
        if b >= n:
            return b
    b = _VOCODER_BUCKETS[-1]
    while b < n:
        b *= 2
    return b


def resolve_device(device: str) -> torch.device:
    """``"cuda"`` (the default everywhere) needs a GPU; ``"cpu"`` is for
    tests and must be asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but no CUDA device is available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


@dataclass
class VoiceProfile:
    """Reference codes ``(num_codebooks, seq_len)`` int64, row 0 semantic,
    plus the reference transcript; ``.npy`` files round-trip."""

    codes: np.ndarray
    text: str = ""
    name: str = ""

    def save(self, path: str | Path) -> None:
        np.save(path, self.codes)

    @classmethod
    def load(cls, path: str | Path, text: str = "", name: str = "") -> "VoiceProfile":
        return cls(codes=np.load(path), text=text, name=name or Path(path).stem)


class _StreamVocoder:
    """One audio stream's stateful codec decode (``models/vocoder_stream``):
    each chunk decodes only its own frames from the carried state, and the
    chunks together equal the joint decode's waveform."""

    def __init__(self, tts: "FishTTS"):
        if tts._vocoder_params is None:
            raise RuntimeError("Vocoder not loaded")
        self._tts = tts
        self._state = vocoder_stream.init_decode_state(tts._vocoder_params, tts._vocoder_cfg)

    def decode_async(self, codes: np.ndarray):
        """Enqueue one chunk (K, n) and its copy to the host; returns the
        handle for ``FishTTS._force_pcm`` and n."""
        tts = self._tts
        self._state, audio = vocoder_stream.decode_chunk(
            tts._vocoder_params, tts._vocoder_cfg, self._state,
            to_device_async(codes[None], tts.device))
        return start_fetch(audio.float()), codes.shape[-1]


class _PoolStreamBatch:
    """The stateful codec of ``synthesize_batch_stream``: one batched state
    (``vocoder_stream.decode_chunk_pool``), one decode per round for every
    stream that flushes and one fetch of its int16 PCM.

    The batched generator keeps live streams in step (the same frames per
    round, the same flush thresholds), so all flushes of a round but a
    stream's final one share one width; a final flush is zero-padded to the
    round's width (the decode is causal, so its emitted samples are exact)
    and no flush of that stream may follow it."""

    def __init__(self, tts: "FishTTS", batch: int):
        if tts._vocoder_params is None:
            raise RuntimeError("Vocoder not loaded")
        self._tts = tts
        self._B = batch
        init, self._dec = tts._pool_vocoder_fns(batch)
        self._state = init(tts._vocoder_params)
        self._finished: set[int] = set()

    def decode_round(self, entries: list[tuple[int, np.ndarray]]):
        """Enqueue the decode of [(stream, (K, m) codes), ...] and the copy of
        its int16 PCM to the host: (host PCM (B, 1, samples), the copy's CUDA
        event, None on the CPU)."""
        W = max(c.shape[1] for _, c in entries)
        codes = np.zeros((self._B, entries[0][1].shape[0], W), np.int32)
        active = np.zeros((self._B,), bool)
        for b, c in entries:
            assert b not in self._finished, "flush after final (padded) flush"
            if c.shape[1] < W:
                self._finished.add(b)
            codes[b, :, :c.shape[1]] = c
            active[b] = True
        dev = self._tts.device
        self._state, pcm = self._dec(self._tts._vocoder_params, self._state,
                                     to_device_async(codes, dev), to_device_async(active, dev),
                                     torch.zeros((self._B,), dtype=torch.bool, device=dev))
        return start_fetch(pcm)


class _ContextBuffer:
    """Rolling code history for the context-streamed codec decode.

    ``take(codes)`` returns ``(decode_input, ctx)``: the chunk with up to
    ``context_frames`` preceding frames put before it (``ctx`` of them),
    and keeps the chunk as future context."""

    def __init__(self, context_frames: int):
        self.context_frames = context_frames
        self._history: list[np.ndarray] = []
        self._n = 0

    def take(self, codes: np.ndarray) -> tuple[np.ndarray, int]:
        ctx = 0
        if self.context_frames > 0 and self._n > 0:
            ctx_codes = np.concatenate(self._history, axis=1)[:, -self.context_frames:]
            ctx = ctx_codes.shape[1]
            codes = np.concatenate([ctx_codes, codes], axis=1)
        self._history.append(codes[:, ctx:])
        self._n += codes.shape[1] - ctx
        # keep only what later context windows can use
        while len(self._history) > 1 and (
                self._n - self._history[0].shape[1] >= self.context_frames):
            self._n -= self._history[0].shape[1]
            self._history.pop(0)
        return codes, ctx


@dataclass
class _PrefillCache:
    """The stored references, consulted when ``references=None``."""

    prompt_text: list[str] = field(default_factory=list)
    prompt_tokens: list[np.ndarray] = field(default_factory=list)
    profiles: list[VoiceProfile] = field(default_factory=list)


class FishTTS:
    """DualAR transformer + DAC vocoder, PyTorch on the card.

    ``_testing_bundle`` is ``(cfg, params, tokenizer, vocoder_cfg,
    vocoder_params)`` with parameters in the port's layout (see
    ``testing.py``); otherwise ``model_dir`` holds config.json,
    tokenizer.tiktoken (and special_tokens.json) with the weights either
    native (lm.safetensors, vocoder.safetensors, vocoder_config.json) or
    the reference's model.pth and codec.pth, converted as they load.

    ``engine_config=EngineConfig(tp_size=..., dp_size=...)`` puts the LM on
    a (dp, tp) mesh over ``devices`` (default: every visible card; on the
    CPU, tp * dp handles to it), as the engine documents; the codec stays on
    ``device``.
    """

    def __init__(self, model_dir: str | Path | None = None, device: str = "cuda",
                 precision: Literal["bf16", "fp16", "fp32", "int8"] = "bf16",
                 warmup: bool = True, *, engine_config: EngineConfig | None = None,
                 seed: int = 0, devices: list | None = None, _testing_bundle=None):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}")
        self.device = resolve_device(device)
        self._precision = precision
        self._is_warmed_up = warmup
        self._prefill_cache = _PrefillCache()
        self._prefill_lock = threading.Lock()
        if _testing_bundle is not None:
            (self._cfg, params, self._tokenizer,
             self._vocoder_cfg, self._vocoder_params) = _testing_bundle
        else:
            if model_dir is None:
                raise ValueError("model_dir is required (the port downloads nothing)")
            (self._cfg, params, self._tokenizer,
             self._vocoder_cfg, self._vocoder_params) = self._load_models(Path(model_dir))

        # int8: bf16 activations and codec, weight-only int8 LM matmuls;
        # otherwise the LM, its cache and the codec in the precision's dtype
        dtype = _DTYPES[precision]
        params = ckpt.to_device(cast_params(params, dtype), self.device)
        if precision == "int8":
            params = quantize_lm_params(params)
        if self._vocoder_params is not None:
            self._vocoder_params = ckpt.to_device(cast_params(self._vocoder_params, dtype),
                                                  self.device)
        self._engine = GenerationEngine(params, self._cfg, self._tokenizer,
                                        engine_cfg=engine_config, seed=seed, devices=devices)
        # RTF and audio seconds follow the loaded codec's frame rate
        self._engine.metrics.audio_tokens_per_sec = (
            self._vocoder_cfg.sample_rate / self._vocoder_cfg.frame_length)
        if warmup:
            self._run_warmup()

    @staticmethod
    def _load_models(d: Path):
        """LM, tokenizer and codec from a checkpoint directory: the native
        ``lm.safetensors`` / ``vocoder.safetensors``, or else the
        reference's ``model.pth`` / ``codec.pth``, converted as they load."""
        t0 = time.perf_counter()
        cfg = DualARConfig.from_json(d)
        tokenizer = FishTokenizer.from_pretrained(d)
        params = ckpt.from_jax_params(ckpt.load_lm_dir(d, cfg))
        logger.info("Transformer loaded in %.1fs", time.perf_counter() - t0)
        # the native format may carry the codec's wiring; the default otherwise
        vcfg = (VocoderConfig.from_json(d) if (d / "vocoder_config.json").exists()
                else VocoderConfig())
        vparams = None
        for name in ("vocoder.safetensors", "codec.pth"):
            if (d / name).exists():
                vparams = ckpt.from_jax_params(ckpt.load_vocoder_file(d / name, vcfg))
                break
        else:
            logger.warning("codec weights not found, vocoder not loaded")
        logger.info("Models loaded in %.1fs", time.perf_counter() - t0)
        return cfg, params, tokenizer, vcfg, vparams

    def _run_warmup(self) -> None:
        """One short generation, the codec at the first decode bucket and
        the stream's 10- and 20-frame chunks; errors propagate.  On the card
        the generation captures the decode graphs a short call meets."""
        t0 = time.perf_counter()
        for response in self._engine.generate_long("Hello.", max_new_tokens=20,
                                                   temperature=0.7, top_p=0.8,
                                                   repetition_penalty=1.1):
            if response.action == "next":
                break
        if self._vocoder_params is not None:
            K = self._vocoder_cfg.num_codebooks
            self._decode_codes(np.zeros((K, 10), np.int64))
            sv = _StreamVocoder(self)
            for n in (10, 20):
                self._force_pcm(*sv.decode_async(np.zeros((K, n), np.int64)))
        logger.info("Warmup complete in %.1fs", time.perf_counter() - t0)

    # -- the reference store ----------------------------------------------

    def set_references(self, profiles: list[VoiceProfile]) -> None:
        """Store voice profiles and prefill them into the engine's KV prefix."""
        with self._prefill_lock:
            self._prefill_cache = _PrefillCache(
                prompt_text=[p.text for p in profiles],
                prompt_tokens=[np.asarray(p.codes) for p in profiles],
                profiles=list(profiles))
            self._engine.set_prefix(self._prefill_cache.prompt_text,
                                    self._prefill_cache.prompt_tokens)
            logger.info("Set %d reference(s)", len(profiles))

    def add_reference(self, profile: VoiceProfile) -> None:
        with self._prefill_lock:
            self._prefill_cache.profiles.append(profile)
            self._prefill_cache.prompt_text.append(profile.text)
            self._prefill_cache.prompt_tokens.append(np.asarray(profile.codes))
            self._engine.set_prefix(self._prefill_cache.prompt_text,
                                    self._prefill_cache.prompt_tokens)
            logger.info("Added reference '%s', total: %d", profile.name,
                        len(self._prefill_cache.profiles))

    def clear_references(self) -> None:
        with self._prefill_lock:
            self._prefill_cache = _PrefillCache()
            self._engine.clear_prefix()
            logger.info("Cleared all references")

    def get_references(self) -> list[VoiceProfile]:
        with self._prefill_lock:
            return list(self._prefill_cache.profiles)

    @property
    def num_references(self) -> int:
        with self._prefill_lock:
            return len(self._prefill_cache.profiles)

    def _get_prompt_data(self, references: list[VoiceProfile] | None
                         ) -> tuple[list[str], list[np.ndarray], bool]:
        """(texts, codes, use the cached prefix): a list given, even an
        empty one, is used as it is; ``None`` takes the stored references,
        through the engine's prefix when it holds them."""
        if references is not None:
            return [p.text for p in references], [np.asarray(p.codes) for p in references], False
        with self._prefill_lock:
            if self._engine.has_prefix:
                return [], [], True
            return (list(self._prefill_cache.prompt_text),
                    list(self._prefill_cache.prompt_tokens), False)

    # -- synthesis -----------------------------------------------------------

    def synthesize(self, text: str, references: list[VoiceProfile] | None = None,
                   temperature: float = 0.7, top_p: float = 0.8,
                   repetition_penalty: float = 1.1, max_tokens: int = 2048) -> bytes:
        """Synthesize speech from text.  Returns WAV bytes."""
        prompt_text, prompt_tokens, use_prefix = self._get_prompt_data(references)
        codes_list = []
        for response in self._engine.generate_long(
            text, max_new_tokens=max_tokens, temperature=temperature, top_p=top_p,
            repetition_penalty=repetition_penalty, prompt_text=prompt_text,
            prompt_tokens=prompt_tokens, use_prefix_cache=use_prefix,
        ):
            if response.action == "sample":
                codes_list.append(response.codes)
            elif response.action == "next":
                break
        if not codes_list or sum(c.shape[1] for c in codes_list) == 0:
            raise RuntimeError("No audio generated")
        return self._decode_to_wav(np.concatenate(codes_list, axis=1))

    def synthesize_batch(self, texts: list[str], references: list[VoiceProfile] | None = None,
                         temperature: float | list[float] = 0.7,
                         top_p: float | list[float] = 0.8,
                         repetition_penalty: float | list[float] = 1.1,
                         max_tokens: int = 2048) -> list[bytes]:
        """Synthesize several texts in one batch: one model pass per frame
        serves every stream, then each is decoded by the codec.  Returns one
        WAV per text; a stream that emitted nothing gets a header-only WAV.
        Sampling parameters take one shared value or one per text."""
        prompt_text, prompt_tokens, use_prefix = self._get_prompt_data(references)
        codes_list = self._engine.generate_batch(
            texts, max_new_tokens=max_tokens, temperature=temperature, top_p=top_p,
            repetition_penalty=repetition_penalty, prompt_text=prompt_text,
            prompt_tokens=prompt_tokens, use_prefix_cache=use_prefix)
        if not codes_list:
            return []
        if all(c.shape[1] == 0 for c in codes_list):
            raise RuntimeError("No audio generated")
        # a stream that stopped on its prefill frame keeps the others' audio
        return [self._decode_to_wav(c) if c.shape[1] else
                to_wav_bytes(np.zeros(0, np.float32), self.sample_rate) for c in codes_list]

    def synthesize_batch_stream(self, texts: list[str],
                                references: list[VoiceProfile] | None = None,
                                chunk_tokens: int = 20, min_first_chunk: int = 10,
                                context_frames: int = 32,
                                temperature: float | list[float] = 0.7,
                                top_p: float | list[float] = 0.8,
                                repetition_penalty: float | list[float] = 1.1,
                                max_tokens: int = 2048,
                                vocoder_mode: Literal["stateful", "context"] = "stateful"
                                ) -> Iterator[list[bytes | None]]:
        """Streaming batched synthesis: all texts decode in one batch, and
        each item yielded is a list of one int16 PCM chunk per text (None
        where that stream did not flush this round).  Each stream flushes at
        ``min_first_chunk`` frames, then every ``chunk_tokens``, then the
        rest, as :meth:`synthesize_stream`.  ``"stateful"`` decodes every
        flushing stream's chunk in one pool decode per round (``_PoolStreamBatch``),
        ``"context"`` each with ``context_frames`` of history, all enqueued
        before any is read back."""
        prompt_text, prompt_tokens, use_prefix = self._get_prompt_data(references)
        B = len(texts)
        bufs: list[list[np.ndarray]] = [[] for _ in range(B)]
        totals = [0] * B
        firsts = [True] * B

        def take(b: int) -> np.ndarray:
            codes = np.concatenate(bufs[b], axis=1)
            bufs[b], totals[b] = [], 0
            return codes

        if vocoder_mode == "stateful":
            pool = _PoolStreamBatch(self, B)

            def flush(b):
                return b, take(b)  # decoded with the round's other flushes

            def emit(handles):
                entries = [h for h in handles if h is not None]
                pcm, copied = pool.decode_round(entries)
                with self._engine.metrics.span("vocoder"):
                    if copied is not None:
                        copied.synchronize()
                    pcm = pcm.numpy()  # (B, 1, samples) int16, one fetch
                fl = self._vocoder_cfg.frame_length
                out: list[bytes | None] = [None] * B
                for b, c in entries:
                    out[b] = pcm[b, 0, :c.shape[1] * fl].tobytes()
                return out
        elif vocoder_mode == "context":
            ctxs = [_ContextBuffer(context_frames) for _ in range(B)]

            def flush(b):
                codes, ctx = ctxs[b].take(take(b))
                handle, n = self._decode_codes_async(codes)
                return handle, n - ctx, ctx

            def emit(handles):
                # every flushing stream's decode is enqueued before any is read
                return [self._force_pcm(*h) if h is not None else None for h in handles]
        else:
            raise ValueError(f"vocoder_mode must be 'stateful' or 'context', not "
                             f"{vocoder_mode!r}")

        for chunk in self._engine.generate_batch_stream(
                texts, max_new_tokens=max_tokens, temperature=temperature, top_p=top_p,
                repetition_penalty=repetition_penalty, prompt_text=prompt_text,
                prompt_tokens=prompt_tokens, use_prefix_cache=use_prefix):
            handles: list = [None] * B
            for b, codes in enumerate(chunk):
                if codes is None:
                    continue
                bufs[b].append(codes)
                totals[b] += codes.shape[1]
                if totals[b] >= (min_first_chunk if firsts[b] else chunk_tokens):
                    handles[b] = flush(b)
                    firsts[b] = False
            if any(h is not None for h in handles):
                yield emit(handles)
        handles = [flush(b) if bufs[b] else None for b in range(B)]
        if any(h is not None for h in handles):
            yield emit(handles)

    def synthesize_stream(self, text: str, references: list[VoiceProfile] | None = None,
                          chunk_tokens: int = 20, min_first_chunk: int = 10,
                          context_frames: int = 32, temperature: float = 0.7,
                          top_p: float = 0.8, repetition_penalty: float = 1.1,
                          max_tokens: int = 2048,
                          vocoder_mode: Literal["stateful", "context"] = "stateful"
                          ) -> Iterator[bytes]:
        """Streaming synthesis: yields raw int16 PCM chunks (mono, the
        codec's rate).  The first flush comes at ``min_first_chunk`` frames,
        then one every ``chunk_tokens``, then the rest.

        The first chunk is decoded and read back at once; every later one is
        enqueued and read back after the next LM chunk has been requested,
        so the device works on it while the host sets up the next step.

        ``vocoder_mode``: ``"stateful"`` (default) carries the codec's exact
        state across chunks (``models/vocoder_stream``), so the chunks
        together equal the joint decode; ``context_frames`` is ignored.
        ``"context"`` decodes ``context_frames`` of history before each
        chunk and trims it.  Unknown keyword arguments raise ``TypeError``.
        """
        if vocoder_mode == "stateful":
            sv = _StreamVocoder(self)

            def flush(buffer):
                handle, n = sv.decode_async(np.concatenate(buffer, axis=1))
                return handle, n, 0
        elif vocoder_mode == "context":
            ctx_buf = _ContextBuffer(context_frames)

            def flush(buffer):
                codes, ctx = ctx_buf.take(np.concatenate(buffer, axis=1))
                handle, n = self._decode_codes_async(codes)
                return handle, n - ctx, ctx
        else:
            raise ValueError(f"vocoder_mode must be 'stateful' or 'context', not "
                             f"{vocoder_mode!r}")
        yield from self._stream_text(
            text, references, flush, first=min_first_chunk, every=chunk_tokens,
            max_tokens=max_tokens, temperature=temperature, top_p=top_p,
            repetition_penalty=repetition_penalty)

    def _stream_text(self, text: str, references: list[VoiceProfile] | None, flush,
                     first: int | None, every: int, max_tokens: int, temperature: float,
                     top_p: float, repetition_penalty: float,
                     collected: list[np.ndarray] | None = None) -> Iterator[bytes]:
        """One text's streamed PCM: ``flush(buffer)`` enqueues the decode of
        the buffered codes and returns a handle for :meth:`_force_pcm`.  The
        first flush, at ``first`` frames, is read back at once (``None``: no
        such flush, every flush at ``every`` frames); every later one is
        read back after the next LM chunk has been requested, so the device
        works on it while the host sets up the next step.  The codes go to
        ``collected`` too when it is given."""
        prompt_text, prompt_tokens, use_prefix = self._get_prompt_data(references)
        buffer: list[np.ndarray] = []
        total = 0
        in_flight = None  # the previous flush's handle, not yet read back
        for response in self._engine.generate_long(
            text, max_new_tokens=max_tokens, temperature=temperature, top_p=top_p,
            repetition_penalty=repetition_penalty, prompt_text=prompt_text,
            prompt_tokens=prompt_tokens, streaming=True, use_prefix_cache=use_prefix,
        ):
            if response.action == "next":
                break
            buffer.append(response.codes)
            if collected is not None:
                collected.append(response.codes)
            total += response.codes.shape[1]
            if total >= (every if first is None else first):
                handle = flush(buffer)
                buffer, total = [], 0
                if first is not None:  # the first audio is what the listener waits for
                    yield self._force_pcm(*handle)
                else:
                    if in_flight is not None:
                        yield self._force_pcm(*in_flight)
                    in_flight = handle
                first = None
        if buffer:
            if in_flight is not None:
                yield self._force_pcm(*in_flight)
            in_flight = flush(buffer)
        if in_flight is not None:
            yield self._force_pcm(*in_flight)

    # -- long text ---------------------------------------------------------------

    def synthesize_long(self, text: str, references: list[VoiceProfile] | None = None,
                        temperature: float = 0.7, top_p: float = 0.8,
                        repetition_penalty: float = 1.1, max_chars: int = 200,
                        carry_frames: int = 64, max_tokens_per_chunk: int = 2048) -> bytes:
        """Synthesis past one context: ``text`` cut into sentence-aware chunks
        of at most ``max_chars`` (``utils.text.split_text``), spoken in turn.
        Returns one WAV of the concatenated PCM of
        :meth:`synthesize_long_stream`; raises when no audio came out.
        ``carry_frames`` bounds the codes of each chunk carried into the next
        one's prompt (~3 s at 64 frames); the references, the carry and the
        chunk's text must fit the prompt, or the engine raises."""
        pcm = b"".join(self.synthesize_long_stream(
            text, references=references, temperature=temperature, top_p=top_p,
            repetition_penalty=repetition_penalty, max_chars=max_chars,
            carry_frames=carry_frames, max_tokens_per_chunk=max_tokens_per_chunk))
        if not pcm:
            raise RuntimeError("No audio generated")
        samples = np.frombuffer(pcm, np.int16).astype(np.float32)
        return to_wav_bytes(samples / 32767.0, self.sample_rate)

    def synthesize_long_stream(self, text: str, references: list[VoiceProfile] | None = None,
                               chunk_tokens: int = 20, min_first_chunk: int = 10,
                               temperature: float = 0.7, top_p: float = 0.8,
                               repetition_penalty: float = 1.1, max_chars: int = 200,
                               carry_frames: int = 64,
                               max_tokens_per_chunk: int = 2048) -> Iterator[bytes]:
        """Streaming :meth:`synthesize_long`: int16 PCM chunks across every
        text chunk, the first after ``min_first_chunk`` frames of the first
        one, as :meth:`synthesize_stream`, then one decode late.

        Chunk ``i > 0`` is prompted with the references plus the pair
        (chunk ``i - 1``'s text, its last ``carry_frames`` codes without the
        EOS frame); ``carry_frames=0`` carries nothing.  Only the first chunk
        may use the stored prefix (``references=None``); the later ones
        prefill their references and carry.  Each text chunk has its own
        stateful codec: chunks end at sentences, so the joins fall in
        pauses."""
        chunks = split_text(text, max_chars)
        base = list(references) if references is not None else self.get_references()
        prev: VoiceProfile | None = None
        for i, chunk_text in enumerate(chunks):
            # None lets the first chunk use the stored prefix
            refs = references if prev is None else base + [prev]
            sv = _StreamVocoder(self)

            def flush(buffer):
                return (*sv.decode_async(np.concatenate(buffer, axis=1)), 0)

            collected: list[np.ndarray] = []
            yield from self._stream_text(
                chunk_text, refs, flush, first=min_first_chunk if i == 0 else None,
                every=chunk_tokens, max_tokens=max_tokens_per_chunk, temperature=temperature,
                top_p=top_p, repetition_penalty=repetition_penalty, collected=collected)
            if collected and carry_frames > 0:  # [:, -0:] would carry the whole chunk
                codes = np.concatenate(collected, axis=1)
                if codes.shape[1] > 1:  # the stream yields the EOS frame: not carried
                    codes = codes[:, :-1]
                prev = VoiceProfile(codes=codes[:, -carry_frames:].astype(np.int64),
                                    text=chunk_text, name="_carry")

    # -- serving ---------------------------------------------------------------

    def serve(self, slots: int = 8, vocoder_device=None, max_queue: int = 0,
              warmup: bool | None = None) -> "ServeSession":
        """Continuous-batching audio serving: a session whose requests join
        the running decode pool (``engine.serve.ContinuousBatcher``) and
        stream int16 PCM per request through one pool-wide stateful codec
        (one decode and one PCM read per round; see :class:`ServeSession`).

        >>> sess = tts.serve(slots=8)
        >>> rid = sess.submit("hello", max_new_tokens=400)
        >>> for ev in sess.run():
        ...     play(ev.request_id, ev.pcm)

        ``vocoder_device``: a device for the pool codec (disaggregated
        serving): its parameters and state live there and its rounds run on
        a CUDA stream of their own, concurrently with the LM's chunks instead
        of queued behind them (see :class:`ServeSession`).  ``None`` keeps
        it on the instance's device and the pool's stream.  ``max_queue``
        bounds the queued requests (``submit`` raises
        ``engine.serve.QueueFull`` at it; 0 = unbounded).
        ``warmup`` drains one tiny request first, so that the pool's graphs
        are captured before the first real request; ``None`` follows the
        instance's own warmup setting."""
        if self._vocoder_params is None:
            raise RuntimeError("Audio serving requires the vocoder; this instance loaded "
                               "without one (LM codes only).")
        sess = ServeSession(self, slots=slots, vocoder_device=vocoder_device,
                            max_queue=max_queue)
        if warmup if warmup is not None else self._is_warmed_up:
            sess.warmup()
        return sess

    # -- the codec -------------------------------------------------------------

    def _decode_codes_async(self, codes: np.ndarray):
        """Enqueue the codec decode of codes (K, n) at the padded bucket
        length and its copy to the host.  Returns (handle, n) for
        :meth:`_force_pcm`."""
        if self._vocoder_params is None:
            raise RuntimeError("Vocoder not loaded")
        n = codes.shape[-1]
        padded = np.zeros((1, codes.shape[0], _vocoder_bucket(n)), np.int64)
        padded[0, :, :n] = codes
        audio = vocoder.dac_decode(self._vocoder_params, self._vocoder_cfg,
                                   to_device_async(padded, self.device))
        return start_fetch(audio.float()), n

    def _pool_vocoder_fns(self, batch: int):
        """The slot pool's (init, decode) pair at ``batch`` rows: ``init(params)``
        a fresh batched state, ``decode(params, state, codes, active, reset)``
        one ``decode_chunk_pool`` round returning (state, int16 PCM (B, 1,
        samples)) made on the device, bit-exact to ``to_pcm_bytes`` of the
        float audio: the codec ends in tanh, so ``x * 32767`` stays inside
        int16, and the conversion truncates toward zero as numpy's does."""
        cfg = self._vocoder_cfg

        def init(params):
            return vocoder_stream.init_decode_state(params, cfg, batch=batch)

        def decode(params, state, codes, active, reset):
            state, audio = vocoder_stream.decode_chunk_pool(params, cfg, state, codes, active,
                                                            reset)
            return state, (audio.float() * 32767).to(torch.int16)

        return init, decode

    @staticmethod
    def _read_audio(handle) -> np.ndarray:
        """Wait for an enqueued decode's host copy: float32 (samples,)."""
        host, copied = handle
        if copied is not None:
            copied.synchronize()
        return host[0, 0].numpy()

    def _force_pcm(self, handle, n_frames: int, skip_frames: int = 0) -> bytes:
        """An enqueued decode as int16 PCM, without ``skip_frames`` of
        (context) audio at the front."""
        with self._engine.metrics.span("vocoder"):
            arr = self._read_audio(handle)
        fl = self._vocoder_cfg.frame_length
        return to_pcm_bytes(arr[skip_frames * fl:(skip_frames + n_frames) * fl])

    def _decode_codes(self, codes: np.ndarray) -> np.ndarray:
        """codes (K, n) -> float32 audio (n * frame_length,), decoded at the
        padded bucket length."""
        with self._engine.metrics.span("vocoder"):
            handle, n = self._decode_codes_async(codes)
            arr = self._read_audio(handle)
        return arr[: n * self._vocoder_cfg.frame_length]

    def _decode_to_wav(self, codes: np.ndarray) -> bytes:
        return to_wav_bytes(self._decode_codes(codes), self.sample_rate)

    def _decode_to_pcm(self, codes: np.ndarray) -> bytes:
        return to_pcm_bytes(self._decode_codes(codes))

    def encode_reference(self, audio_bytes: bytes, text: str) -> VoiceProfile:
        """A voice profile from reference WAV audio and its transcript: the
        audio at the codec's rate, zero-padded to a frame bucket, encoded
        (``vocoder.dac_encode``) on the instance's device in the codec's
        dtype; the codes of its frames, int64 (K, frames)."""
        if self._vocoder_params is None:
            raise RuntimeError("Vocoder not loaded")
        audio = read_wav(audio_bytes, self.sample_rate)
        fl = self._vocoder_cfg.frame_length
        n_frames = max(1, -(-len(audio) // fl))
        padded = np.zeros((1, 1, _vocoder_bucket(n_frames) * fl), np.float32)
        padded[0, 0, :len(audio)] = audio
        dtype = self._vocoder_params["encoder"]["stem"]["w"].dtype
        codes = vocoder.dac_encode(self._vocoder_params, self._vocoder_cfg,
                                   torch.from_numpy(padded).to(self.device, dtype))
        return VoiceProfile(codes=codes[0, :, :n_frames].cpu().numpy().astype(np.int64),
                            text=text)

    @property
    def engine(self) -> GenerationEngine:
        return self._engine

    @property
    def metrics(self):
        """The engine's metrics registry (prefill/decode/vocoder spans, tokens)."""
        return self._engine.metrics

    def get_metrics(self) -> dict:
        """Timing and throughput summary, plus the device memory in use."""
        out = self._engine.metrics.summary()
        hbm = hbm_bytes_in_use(self.device)
        if hbm:
            out["hbm_gb"] = round(hbm / 2**30, 2)
        return out

    @property
    def sample_rate(self) -> int:
        return self._vocoder_cfg.sample_rate

    @property
    def precision(self) -> str:
        return self._precision


@dataclass
class AudioEvent:
    """One serving round's audio for one request."""

    request_id: int
    pcm: bytes  # int16 PCM, mono, the codec's rate (b"" on a frame-less finish)
    done: bool
    frames_total: int  # cumulative LM frames emitted for this request


class _LongChain:
    """A long request in serving: one external id, a chain of LM requests
    (one per text chunk) and one continuous audio stream.

    Segment i > 0 is prompted with the base references plus (chunk i - 1,
    its trailing ``carry_frames`` codes), unless the engine holds a session
    prefix (then the prefix is the voice and successors submit plain text).
    The pool codec's state carries across segments, with no reset."""

    __slots__ = ("chunks", "idx", "cur", "base_texts", "base_codes", "carry_frames", "kw",
                 "seed", "deadline", "tail", "frames_offset", "aliases", "pending",
                 "pending_kw")

    def __init__(self, chunks, base_texts, base_codes, carry_frames, kw, seed, deadline):
        self.chunks = chunks
        self.idx = 1  # next chunk to submit
        self.cur = -1  # current internal request id
        self.base_texts = base_texts
        self.base_codes = base_codes
        self.carry_frames = carry_frames
        self.kw = kw  # sampling and priority arguments of the successors
        self.seed = seed
        self.deadline = deadline  # absolute time.monotonic(); 0 = none
        self.tail: np.ndarray | None = None  # the current segment's last codes
        self.frames_offset = 0  # frames finished in earlier segments
        self.aliases: list[int] = []  # the successors' internal ids
        # a prepared successor kept across QueueFull retries (its carry is
        # already taken)
        self.pending = None
        # a successor's arguments not yet prepared (prepare raised QueueFull):
        # the carry lives in here
        self.pending_kw = None

    def feed(self, codes: np.ndarray) -> None:
        """Keep the current segment's trailing codes (one spare frame, so the
        EOS frame can be dropped at the segment's end)."""
        keep = self.carry_frames + 1
        tail = codes if self.tail is None else np.concatenate([self.tail, codes], axis=1)
        self.tail = tail[:, -keep:]

    def take_carry(self) -> np.ndarray | None:
        """The finished segment's carry codes, its EOS frame dropped."""
        tail = self.tail
        self.tail = None
        if self.carry_frames <= 0 or tail is None or tail.shape[1] == 0:
            return None
        if tail.shape[1] > 1:
            tail = tail[:, :-1]
        return tail[:, -self.carry_frames:].astype(np.int64)


class _SlotAudioStream:
    """One request's audio stream in a lane of the pool codec."""

    __slots__ = ("rid", "bufs", "buffered", "needs_reset", "lm_done", "frames_total")

    def __init__(self, rid: int):
        self.rid = rid
        self.bufs: list[np.ndarray] = []  # FIFO of (K, m) code chunks
        self.buffered = 0
        self.needs_reset = True  # the first flush restarts the lane's stream
        self.lm_done = False
        self.frames_total = 0

    def take(self, m: int) -> np.ndarray:
        """Pop the oldest ``m`` buffered frames."""
        out, need = [], m
        while need:
            head = self.bufs[0]
            if head.shape[1] <= need:
                out.append(self.bufs.pop(0))
                need -= head.shape[1]
            else:
                out.append(head[:, :need])
                self.bufs[0] = head[:, need:]
                need = 0
        self.buffered -= m
        return out[0] if len(out) == 1 else np.concatenate(out, axis=1)


class ServeSession:
    """Audio-level continuous batching (made by :meth:`FishTTS.serve`).

    LM side: one :class:`~fish_tts_tpu_torch.engine.serve.ContinuousBatcher`
    slot pool.  Audio side: one pool-wide stateful codec
    (``vocoder_stream.decode_chunk_pool``, int16 PCM made on the device) with
    as many lanes as LM slots, a lane taken from a free pool per audio
    stream (not keyed by LM slot: a long chain keeps its lane across its
    segments while its LM slots are recycled).  Every flushing stream's chunk
    decodes in one call per round, its PCM comes back through one pinned
    copy and an event, and it is read one round late, so the copy overlaps
    the next round's work.

    Flushes are ``decode_chunk`` frames wide; a request's shorter final
    chunk is zero-padded into the same call (the decode is causal, so its
    samples are exact) and the host truncates.  Streamed PCM includes the
    EOS frame, as ``synthesize_stream``'s does.

    ``vocoder_device`` (disaggregated serving, JAX ``synthesizer.py:1283-
    1305``): the pool codec's parameters and state live on that device and
    its rounds run on a CUDA stream of its own there: on a second card that
    card's work, on the LM's card a second stream, so a round no longer
    queues behind the LM chunk.  Its codes go there with
    ``to_device_async`` on that stream, and its PCM read waits on that
    stream's event.  Everything a round makes is made on that stream;
    the parameters, placed on the instance's stream, are waited for once."""

    def __init__(self, tts: FishTTS, slots: int = 8, vocoder_device=None, max_queue: int = 0):
        from fish_tts_tpu_torch.engine.serve import ContinuousBatcher

        self._tts = tts
        self._srv = ContinuousBatcher(tts._engine, slots=slots, max_queue=max_queue)
        self._slots = slots
        self._n = self._srv.chunk  # the flush width: the LM chunk's frames
        self._vdev = self._vstream = None
        self._vparams = tts._vocoder_params
        if vocoder_device is not None:
            self._vdev = resolve_device(vocoder_device)
            self._vparams = ckpt.to_device(tts._vocoder_params, self._vdev)
            if self._vdev.type == "cuda":
                self._vstream = torch.cuda.Stream(self._vdev)
                # the parameters' copies were queued on the device's current stream
                self._vstream.wait_stream(torch.cuda.current_stream(self._vdev))
        init, self._decode = tts._pool_vocoder_fns(slots)
        with self._on_codec_stream():
            self._state = init(self._vparams)
        self._streams: dict[int, _SlotAudioStream] = {}
        # per lane, a FIFO of audio streams: [0] flushes, the rest wait
        self._slot_q: list[list[_SlotAudioStream]] = [[] for _ in range(slots)]
        self._cancel_lock = threading.Lock()
        self._cancel_pending: set[int] = set()
        self._cancel_drop: dict[int, int] = {}  # rid -> rounds left to drop
        # long chains: external id -> _LongChain; a successor's internal id
        # -> external id (both under _cancel_lock)
        self._chains: dict[int, _LongChain] = {}
        self._alias: dict[int, int] = {}
        # chains whose next segment met QueueFull, retried each round
        self._chain_retry: dict[int, _LongChain] = {}
        # one codec round in flight: ((host PCM, copy event) | None, emits)
        self._pending = None

    def _on_codec_stream(self):
        """A context that makes the pool codec's stream current: its own on
        a ``vocoder_device`` card, else the LM pool's."""
        if self._vstream is not None:
            return torch.cuda.stream(self._vstream)
        if self._vdev is not None:
            return contextlib.nullcontext()
        return self._srv.on_stream()

    def submit(self, text: str, *, max_new_tokens: int = 2048, temperature: float = 0.7,
               top_p: float = 0.8, repetition_penalty: float = 1.1, seed: int | None = None,
               references: list[VoiceProfile] | None = None, priority: int = 0,
               timeout_s: float = 0.0, long: bool = False, max_chars: int = 200,
               carry_frames: int = 64, **kw) -> int:
        """Queue a request; returns its id.  Thread-safe.  ``seed`` pins its
        sampling to its solo run's (``engine.serve``); ``references`` are
        per-request voices, inlined into its prompt (not with a session
        prefix).  ``long`` splits the text into sentence-aware chunks of
        ``max_chars`` that decode as a chain of pool requests under this one
        id, each prompted with its predecessor's text and last
        ``carry_frames`` codes; the consumer sees one PCM stream with one
        final done event, ``timeout_s`` bounds the whole chain and ``seed``
        gives chunk i the seed ``seed + i``.  Other keyword arguments go to
        ``ContinuousBatcher.prepare``."""
        return self.enqueue(self.prepare(
            text, max_new_tokens=max_new_tokens, temperature=temperature, top_p=top_p,
            repetition_penalty=repetition_penalty, seed=seed, references=references,
            priority=priority, timeout_s=timeout_s, long=long, max_chars=max_chars,
            carry_frames=carry_frames, **kw))

    def prepare(self, text: str, *, references=None, long=False, max_chars=200,
                carry_frames=64, **kw):
        """The host work of a request (tokenize, prompt, key) without
        touching the scheduler; pair with :meth:`enqueue`."""
        from fish_tts_tpu_torch.utils.text import split_text

        base_texts = [r.text for r in references] if references else []
        base_codes = [np.asarray(r.codes) for r in references] if references else []
        if not long:
            if references:
                kw["prompt_text"], kw["prompt_tokens"] = base_texts, base_codes
            return self._srv.prepare(text, **kw)
        chunks = split_text(text, int(max_chars))
        if not chunks:
            raise ValueError("long request has no synthesizable text")
        kw0 = dict(kw)
        if references:
            kw0["prompt_text"], kw0["prompt_tokens"] = base_texts, base_codes
        req = self._srv.prepare(chunks[0], **kw0)
        if len(chunks) > 1:
            timeout_s = float(kw.get("timeout_s", 0.0))
            # the successors' arguments (timeout_s is recomputed per segment
            # from the chain's deadline)
            chain_kw = {k: v for k, v in kw.items() if k not in ("seed", "timeout_s")}
            req._long_chain = _LongChain(
                chunks, base_texts, base_codes, int(carry_frames), chain_kw, kw.get("seed"),
                (time.monotonic() + timeout_s) if timeout_s else 0.0)
        return req

    def enqueue(self, req) -> int:
        """Queue a prepared request (cheap, thread-safe); returns its id."""
        chain = getattr(req, "_long_chain", None)
        rid = self._srv.enqueue(req)
        if chain is not None:
            chain.cur = rid
            with self._cancel_lock:
                self._chains[rid] = chain
        return rid

    def cancel(self, request_id: int) -> None:
        """Abort a request at the next round: its LM slot stops, its buffered
        codes are dropped and no further audio events come for its id.  A
        long request's external id aborts its whole chain."""
        with self._cancel_lock:
            chain = self._chains.pop(request_id, None)
            if chain is not None:
                for a in chain.aliases:
                    self._alias.pop(a, None)
                # an event in flight for a successor would resolve to its
                # raw id once the alias is gone: cancel those ids too
                self._cancel_pending.update(chain.aliases)
            self._cancel_pending.add(request_id)
        self._srv.cancel(chain.cur if chain is not None and chain.cur >= 0 else request_id)

    def _chain_next(self, eid: int, chain: _LongChain) -> str:
        """Submit a long request's next segment: ``"ok"`` (enqueued),
        ``"retry"`` (the queue is full; kept for the next round) or
        ``"end"`` (deadline passed, the prompt no longer fits, or
        cancelled: the stream ends with the audio made so far)."""
        from fish_tts_tpu_torch.engine.serve import QueueFull

        now = time.monotonic()
        if chain.deadline and now >= chain.deadline:
            return "end"
        idx = chain.idx
        req = chain.pending
        if req is None:
            kw = chain.pending_kw
            if kw is None:
                kw = dict(chain.kw)
                if chain.seed is not None:
                    kw["seed"] = chain.seed + idx
                carry = chain.take_carry()
                if not self._tts._engine.has_prefix:
                    # the rolling context; without a carry (EOS on its first
                    # frame) the base references still go with it
                    if carry is not None:
                        kw["prompt_text"] = chain.base_texts + [chain.chunks[idx - 1]]
                        kw["prompt_tokens"] = chain.base_codes + [carry]
                    elif chain.base_texts:
                        kw["prompt_text"] = list(chain.base_texts)
                        kw["prompt_tokens"] = list(chain.base_codes)
            if chain.deadline:
                kw["timeout_s"] = chain.deadline - now
            try:
                req = self._srv.prepare(chain.chunks[idx], **kw)
            except QueueFull:
                chain.pending_kw = kw  # the taken carry lives in kw
                return "retry"
            except ValueError as e:
                logger.warning("long request %d: chain ended early at chunk %d/%d: %s",
                               eid, idx, len(chain.chunks), e)
                return "end"
            chain.pending_kw = None
        # enqueue and registration together against cancel(): a cancel after
        # this block cancels the successor; one before it ends the chain
        with self._cancel_lock:
            if self._chains.get(eid) is not chain:
                return "end"  # cancelled at the segment boundary
            try:
                nid = self._srv.enqueue(req)
            except QueueFull:
                chain.pending = req
                return "retry"
            chain.pending = None
            chain.idx += 1
            chain.cur = nid
            chain.aliases.append(nid)
            self._alias[nid] = eid
        return "ok"

    def reset(self) -> None:
        """Rebuild the session after a failed ``step()``: the LM pool and the
        pool codec's state start afresh and every live request is dropped
        (the driver has already ended their consumers' streams)."""
        self._srv.reset()
        init, _ = self._tts._pool_vocoder_fns(self._slots)
        with self._on_codec_stream():
            self._state = init(self._vparams)
        self._streams.clear()
        self._slot_q = [[] for _ in range(self._slots)]
        self._pending = None
        self._chain_retry.clear()
        with self._cancel_lock:
            self._chains.clear()
            self._alias.clear()
            self._cancel_pending.clear()
            self._cancel_drop.clear()

    def _pick_lane(self) -> int:
        """The codec lane of a new audio stream: a free one, else the lane
        with the least pending work, avoiding live chains."""
        best, best_key = 0, None
        for s, q in enumerate(self._slot_q):
            if not q:
                return s
            live_chain = any(not st.lm_done and st.rid in self._chains for st in q)
            live = any(not st.lm_done for st in q)
            key = (live_chain, live, len(q), sum(st.buffered for st in q))
            if best_key is None or key < best_key:
                best, best_key = s, key
        return best

    def stats(self) -> dict:
        """The LM scheduler's serving stats (``ContinuousBatcher.stats``)."""
        return self._srv.stats()

    def step(self) -> list[AudioEvent]:
        """One scheduler round; returns the previous round's audio events
        (audio is read one round late, so its copy overlaps device work)."""
        with self._srv.on_stream():
            return self._step()

    def _step(self) -> list[AudioEvent]:
        with self._cancel_lock:
            cancelled, self._cancel_pending = self._cancel_pending, set()
        for rid in cancelled:
            st = self._streams.pop(rid, None)
            if st is not None:
                for q in self._slot_q:
                    if st in q:
                        q.remove(st)
                        break
            # LM events and audio in flight for this id may land for a couple
            # of rounds (the pipeline is two rounds deep): drop them by id
            self._cancel_drop[rid] = 4
        for rid in [r for r, n in self._cancel_drop.items() if n <= 1]:
            del self._cancel_drop[rid]
        for rid in self._cancel_drop:
            self._cancel_drop[rid] -= 1
        instant_done: list[AudioEvent] = []
        for eid in list(self._chain_retry):
            chain = self._chain_retry[eid]
            r = self._chain_next(eid, chain)
            if r == "retry":
                continue
            del self._chain_retry[eid]
            if r == "end":
                with self._cancel_lock:
                    self._chains.pop(eid, None)
                    for a in chain.aliases:
                        self._alias.pop(a, None)
                st = self._streams.get(eid)
                if st is not None:
                    st.lm_done = True  # drain the tail, then emit done
                elif eid not in self._cancel_drop:
                    instant_done.append(AudioEvent(eid, b"", True, chain.frames_offset))
        for ev in self._srv.step():
            with self._cancel_lock:
                eid = self._alias.get(ev.request_id, ev.request_id)
                chain = self._chains.get(eid)
            if eid in self._cancel_drop:
                continue
            done, frames_total = ev.done, ev.frames_total
            if chain is not None:
                frames_total += chain.frames_offset
                if ev.codes.shape[1]:
                    chain.feed(ev.codes)
                if done:
                    # chain on unless this segment failed (expiry and
                    # rejection events carry slot -1) or was the last
                    if ev.slot != -1 and chain.idx < len(chain.chunks):
                        r = self._chain_next(eid, chain)
                    else:
                        r = "end"
                    if r != "end":
                        done = False
                        chain.frames_offset = frames_total
                        if r == "retry":
                            self._chain_retry[eid] = chain
                    else:
                        with self._cancel_lock:
                            self._chains.pop(eid, None)
                            for a in chain.aliases:
                                self._alias.pop(a, None)
            st = self._streams.get(eid)
            if st is None:
                if done and not ev.codes.shape[1]:
                    # a frame-less finish of a stream never seen (an expiry
                    # while queued): end it without touching the lanes
                    instant_done.append(AudioEvent(eid, b"", True, frames_total))
                    continue
                st = _SlotAudioStream(eid)
                self._streams[eid] = st
                self._slot_q[self._pick_lane()].append(st)
            if ev.codes.shape[1]:
                st.bufs.append(ev.codes)
                st.buffered += ev.codes.shape[1]
            st.lm_done |= done
            st.frames_total = frames_total

        n = self._n
        codes = np.zeros((self._slots, self._tts._cfg.num_codebooks, n), np.int32)
        active = np.zeros((self._slots,), bool)
        reset = np.zeros((self._slots,), bool)
        emits: list[tuple[int, _SlotAudioStream, int, bool]] = []
        for s in range(self._slots):
            q = self._slot_q[s]
            if not q:
                continue
            st = q[0]
            if st.lm_done and not st.buffered:  # frame-less finish
                emits.append((s, st, 0, True))
                q.pop(0)
                del self._streams[st.rid]
            elif st.buffered >= n or (st.lm_done and st.buffered):
                m = min(n, st.buffered)
                codes[s, :, :m] = st.take(m)
                active[s] = True
                reset[s] = st.needs_reset
                st.needs_reset = False
                done = st.lm_done and not st.buffered
                emits.append((s, st, m, done))
                if done:
                    q.pop(0)
                    del self._streams[st.rid]
        audio = None
        if active.any():
            dev = self._vdev or self._tts.device
            with self._on_codec_stream():
                self._state, pcm = self._decode(
                    self._vparams, self._state, to_device_async(codes, dev),
                    to_device_async(active, dev), to_device_async(reset, dev))
                audio = start_fetch(pcm)  # read next round, after this stream's event
        nxt = (audio, emits) if (audio is not None or emits) else None
        out = self._emit(*self._pending) if self._pending is not None else []
        self._pending = nxt
        return instant_done + out

    def _emit(self, audio, emits) -> list[AudioEvent]:
        fl = self._tts._vocoder_cfg.frame_length
        arr = None
        if audio is not None:
            host, copied = audio
            with self._tts._engine.metrics.span("vocoder"):
                if copied is not None:
                    copied.synchronize()
                arr = host.numpy()  # (slots, 1, samples) int16
        return [AudioEvent(st.rid, arr[s, 0, :m * fl].tobytes() if m else b"", done,
                           st.frames_total)
                for s, st, m, done in emits if st.rid not in self._cancel_drop]

    @property
    def busy(self) -> bool:
        return (self._srv.busy or self._pending is not None or any(self._slot_q)
                or bool(self._chain_retry))

    def run(self) -> Iterator[AudioEvent]:
        """Drive the session until the queue and every slot drain."""
        while self.busy:
            yield from self.step()

    def warmup(self) -> None:
        """Drain one tiny request through the session, so that the pool's
        first graphs are captured and the codec's first round has run
        before the first real request."""
        t0 = time.perf_counter()
        self.submit("Warm up.", max_new_tokens=2 * self._n, seed=0)
        for _ in self.run():
            pass  # the warmup request's audio is dropped
        logger.info("Serve pool warmup (%d slots) in %.1fs", self._slots,
                    time.perf_counter() - t0)


def get_instance(model_dir: str | Path | None = None, device: str = "cuda",
                 precision: Literal["bf16", "fp16", "fp32", "int8"] = "bf16",
                 warmup: bool = True, engine_config: EngineConfig | None = None) -> FishTTS:
    """Get or create the process-wide FishTTS instance."""
    global _instance
    with _instance_lock:
        if _instance is None:
            _instance = FishTTS(model_dir=model_dir, device=device, precision=precision,
                                warmup=warmup, engine_config=engine_config)
        return _instance


def reset_instance() -> None:
    """Drop the process-wide instance."""
    global _instance
    with _instance_lock:
        _instance = None
