"""The public API: ``FishTTS.synthesize(text) -> WAV bytes`` on the card.

Port of the non-streaming surface of ``fish_tts_tpu/synthesizer.py``:
``FishTTS`` (from a native model directory or a testing bundle, precision
``bf16`` by default, ``fp16``, ``fp32`` or ``int8``), ``synthesize`` with
``references=`` per call, the engine's ``metrics`` and ``get_metrics()``,
``VoiceProfile`` and the ``get_instance``/``reset_instance`` singleton.
A float precision casts the LM and the codec to that dtype (the KV cache
follows); ``int8`` keeps bf16 activations and codec with weight-only int8
LM matmuls, the route of the three kernels.
Entry points run on the card unless the caller asks for ``device="cpu"``;
``device="cuda"`` without a GPU raises.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Literal

import numpy as np
import torch

from fish_tts_tpu_torch.config import DualARConfig, EngineConfig, VocoderConfig
from fish_tts_tpu_torch.engine.generate import GenerationEngine
from fish_tts_tpu_torch.models import vocoder
from fish_tts_tpu_torch.models.dual_ar import cast_params
from fish_tts_tpu_torch.models.tokenizer import FishTokenizer
from fish_tts_tpu_torch.utils import checkpoint as ckpt
from fish_tts_tpu_torch.utils.audio import to_wav_bytes
from fish_tts_tpu_torch.utils.profiling import hbm_bytes_in_use
from fish_tts_tpu_torch.utils.quantize import quantize_lm_params

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


class FishTTS:
    """DualAR transformer + DAC vocoder, PyTorch on the card.

    ``_testing_bundle`` is ``(cfg, params, tokenizer, vocoder_cfg,
    vocoder_params)`` with parameters in the port's layout (see
    ``testing.py``); otherwise ``model_dir`` holds a native checkpoint
    (config.json, tokenizer.tiktoken, lm.safetensors, vocoder.safetensors).
    """

    def __init__(self, model_dir: str | Path | None = None, device: str = "cuda",
                 precision: Literal["bf16", "fp16", "fp32", "int8"] = "bf16",
                 warmup: bool = True, *, engine_config: EngineConfig | None = None,
                 seed: int = 0, _testing_bundle=None):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}")
        self.device = resolve_device(device)
        self._precision = precision
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
                                        engine_cfg=engine_config, seed=seed)
        # RTF and audio seconds follow the loaded codec's frame rate
        self._engine.metrics.audio_tokens_per_sec = (
            self._vocoder_cfg.sample_rate / self._vocoder_cfg.frame_length)
        if warmup:
            self._run_warmup()

    @staticmethod
    def _load_models(d: Path):
        t0 = time.perf_counter()
        cfg = DualARConfig.from_json(d)
        tokenizer = FishTokenizer.from_pretrained(d)
        if not (d / "lm.safetensors").exists():
            raise FileNotFoundError(f"No lm.safetensors in {d}")
        params = ckpt.from_jax_params(ckpt.load_params(d / "lm.safetensors"))
        vcfg = (VocoderConfig.from_json(d) if (d / "vocoder_config.json").exists()
                else VocoderConfig())
        vparams = None
        if (d / "vocoder.safetensors").exists():
            vparams = ckpt.from_jax_params(ckpt.load_params(d / "vocoder.safetensors"))
        else:
            logger.warning("vocoder.safetensors not found, vocoder not loaded")
        logger.info("Models loaded in %.1fs", time.perf_counter() - t0)
        return cfg, params, tokenizer, vcfg, vparams

    def _run_warmup(self) -> None:
        """One short generation and one vocoder decode; errors propagate.
        On the card the generation captures the decode graphs a short call
        meets."""
        t0 = time.perf_counter()
        for response in self._engine.generate_long("Hello.", max_new_tokens=20,
                                                   temperature=0.7, top_p=0.8,
                                                   repetition_penalty=1.1):
            if response.action == "next":
                break
        if self._vocoder_params is not None:
            self._decode_codes(np.zeros((self._vocoder_cfg.num_codebooks, 10), np.int64))
        logger.info("Warmup complete in %.1fs", time.perf_counter() - t0)

    def synthesize(self, text: str, references: list[VoiceProfile] | None = None,
                   temperature: float = 0.7, top_p: float = 0.8,
                   repetition_penalty: float = 1.1, max_tokens: int = 2048) -> bytes:
        """Synthesize speech from text.  Returns WAV bytes."""
        references = references or []
        codes_list = []
        for response in self._engine.generate_long(
            text, max_new_tokens=max_tokens, temperature=temperature, top_p=top_p,
            repetition_penalty=repetition_penalty,
            prompt_text=[p.text for p in references],
            prompt_tokens=[np.asarray(p.codes) for p in references],
        ):
            if response.action == "sample":
                codes_list.append(response.codes)
            elif response.action == "next":
                break
        if not codes_list or sum(c.shape[1] for c in codes_list) == 0:
            raise RuntimeError("No audio generated")
        return self._decode_to_wav(np.concatenate(codes_list, axis=1))

    @torch.no_grad()
    def _decode_codes(self, codes: np.ndarray) -> np.ndarray:
        """codes (K, n) -> float32 audio (n * frame_length,), decoded at the
        padded bucket length."""
        if self._vocoder_params is None:
            raise RuntimeError("Vocoder not loaded")
        n = codes.shape[-1]
        padded = np.zeros((1, codes.shape[0], _vocoder_bucket(n)), np.int64)
        padded[0, :, :n] = codes
        with self._engine.metrics.span("vocoder"):
            audio = vocoder.dac_decode(self._vocoder_params, self._vocoder_cfg,
                                       torch.as_tensor(padded, device=self.device))
            arr = audio[0, 0].float().cpu().numpy()
        return arr[: n * self._vocoder_cfg.frame_length]

    def _decode_to_wav(self, codes: np.ndarray) -> bytes:
        return to_wav_bytes(self._decode_codes(codes), self.sample_rate)

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
