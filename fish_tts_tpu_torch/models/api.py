"""Object-style handles over the functional model core, the port of
``fish_tts_tpu/models/api.py``.

The reference exposes classes from ``fish_tts.models``:
``DualARTransformer``, ``DAC``, ``DownsampleResidualVectorQuantize``,
``WindowLimitedTransformer``, plus ``init_model``/``generate_long``.  The
port's core is functional (trees of tensors and plain functions), so these
classes are thin handles that bundle ``(config, params)`` and call
``models/dual_ar.py`` and ``models/vocoder.py``.  Code written against that
surface ports by changing the package name; new code should call the
functional modules, or ``FishTTS``, directly.

``from_pretrained`` reads either checkpoint format (native safetensors or
the reference's ``model.pth``/``codec.pth``) and puts the weights on
``device``, the card unless the caller asks for ``"cpu"``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator

import numpy as np
import torch

from fish_tts_tpu_torch.config import DualARConfig, VocoderConfig, VocoderTransformerConfig
from fish_tts_tpu_torch.models import dual_ar, vocoder
from fish_tts_tpu_torch.models.tokenizer import FishTokenizer
from fish_tts_tpu_torch.utils import checkpoint as ckpt

Params = dict


def _device(device: str) -> torch.device:
    from fish_tts_tpu_torch.synthesizer import resolve_device

    return resolve_device(device)


class DualARTransformer:
    """Handle over the functional DualAR LM (the reference's
    ``DualARTransformer``): ``(config, params, tokenizer)`` with the
    forward pieces of ``models/dual_ar.py``.  Decoding belongs to
    :class:`~fish_tts_tpu_torch.engine.generate.GenerationEngine`."""

    def __init__(self, config: DualARConfig, params: Params, tokenizer=None):
        self.config = config
        self.params = params
        self.tokenizer = tokenizer
        self.rope = dual_ar.make_rope_tables(config, device=params["norm"].device)

    @classmethod
    def from_pretrained(cls, path: str | Path, device: str = "cuda") -> "DualARTransformer":
        """Config, tokenizer and LM weights from a checkpoint directory
        (``lm.safetensors`` or ``model.pth``), on ``device``."""
        d = Path(path)
        cfg = DualARConfig.from_json(d)
        tokenizer = FishTokenizer.from_pretrained(d)
        params = ckpt.from_jax_params(ckpt.load_lm_dir(d, cfg), _device(device))
        return cls(cfg, params, tokenizer)

    def token_ids(self) -> dual_ar.TokenIds:
        tk = self.tokenizer
        if tk is None:
            raise ValueError("No tokenizer attached")
        return dual_ar.TokenIds(semantic_begin=tk.semantic_begin_id,
                                semantic_end=tk.semantic_end_id, im_end=tk.im_end_id)

    def embed(self, inp: torch.Tensor) -> torch.Tensor:
        """Token + codebook embedding of ``inp`` (B, 1+K, T)."""
        return dual_ar.embed_inputs(self.params, self.config, self.token_ids(), inp)

    def forward_generate(self, inp: torch.Tensor, positions: torch.Tensor, kv_cache,
                         cache_bias, block_bias, read_len=None):
        """Slow forward writing the KV cache (in place).  Returns (hidden,
        kv_cache); take logits with :meth:`lm_logits`."""
        hidden = dual_ar.slow_forward(self.params, self.config, self.token_ids(), self.rope,
                                      inp, positions, kv_cache, cache_bias, block_bias,
                                      read_len=read_len)
        return hidden, kv_cache

    def forward_generate_fast(self, x: torch.Tensor, pos, fast_cache):
        """One fast-transformer step at codebook position ``pos``.  ``x`` is
        the slow hidden (dim wide): the ``fast_project_in`` bridge of a
        ``fast_dim != dim`` checkpoint is applied here.  Returns (logits,
        fast_cache), the cache written in place."""
        x = dual_ar.project_fast_in(self.params, x)
        logits = dual_ar.fast_step(self.params, self.config, self.rope, x, int(pos), fast_cache)
        return logits, fast_cache

    def lm_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return dual_ar.lm_logits(self.params, self.config, hidden)

    def setup_caches(self, batch: int, max_seq_len: int | None = None):
        """A fresh KV cache (returned, not stored), in the parameters'
        dtype and device."""
        norm = self.params["norm"]
        return dual_ar.init_kv_cache(self.config, batch, max_seq_len, dtype=norm.dtype,
                                     device=norm.device)


class WindowLimitedTransformer:
    """Sliding-window causal transformer on channels-first input."""

    def __init__(self, config: VocoderTransformerConfig, params: Params, window: int):
        self.config = config
        self.params = params
        self.window = window

    @torch.no_grad()
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return vocoder._wlt_forward(self.params, self.config, self.window, x)


class DownsampleResidualVectorQuantize:
    """Grouped semantic + residual RVQ with conv down/upsampling."""

    def __init__(self, config: VocoderConfig, params: Params):
        self.config = config
        self.params = params  # the "quantizer" sub-tree

    @torch.no_grad()
    def encode(self, z: torch.Tensor) -> torch.Tensor:
        """latent (B, C, T) -> codes (B, 1+R, T/downsample)."""
        return vocoder.quantizer_encode(self.params, self.config, z)

    @torch.no_grad()
    def decode(self, indices: torch.Tensor) -> torch.Tensor:
        """codes (B, 1+R, T') -> latent (B, C, T'*downsample); out-of-range
        codes clamp."""
        return vocoder.quantizer_decode(self.params, self.config, indices)

    # the reference's name (from_codes on the inner RVQs feeds decode)
    from_codes = decode


class DAC:
    """Codec handle (the reference's ``DAC``): 44.1 kHz audio <-> (1+9, N)
    code matrices at 2048 samples per frame."""

    def __init__(self, config: VocoderConfig | None = None, params: Params | None = None):
        self.config = config or VocoderConfig()
        self.params = params
        # always set, so that a handle without parameters fails on use
        self.quantizer = (DownsampleResidualVectorQuantize(self.config, params["quantizer"])
                          if params is not None else None)

    @classmethod
    def from_pretrained(cls, path: str | Path, config: VocoderConfig | None = None,
                        device: str = "cuda") -> "DAC":
        """Codec weights from a directory (``vocoder.safetensors``, else
        ``codec.pth``) or a file of either kind, on ``device``."""
        cfg = config or VocoderConfig()
        d = Path(path)
        f = d
        if d.is_dir():
            f = d / "vocoder.safetensors"
            if not f.exists():
                f = d / "codec.pth"
        return cls(cfg, ckpt.from_jax_params(ckpt.load_vocoder_file(f, cfg), _device(device)))

    @property
    def sample_rate(self) -> int:
        return self.config.sample_rate

    @property
    def frame_length(self) -> int:
        return self.config.frame_length

    def encode(self, audio: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """audio (B, 1, T) -> (codes (B, 1+R, N), feature_lengths (B,)) with
        N = ceil(T / frame_length)."""
        n = -(-audio.shape[-1] // self.config.frame_length)
        codes = vocoder.dac_encode(self.params, self.config, audio)
        return codes, torch.full((audio.shape[0],), n, dtype=torch.int32, device=codes.device)

    def decode(self, indices: torch.Tensor,
               feature_lengths=None) -> tuple[torch.Tensor, torch.Tensor]:
        """codes (B, 1+R, N) -> (audio (B, 1, N*frame_length),
        audio_lengths (B,))."""
        audio = vocoder.dac_decode(self.params, self.config, indices)
        if feature_lengths is None:
            feature_lengths = torch.full((indices.shape[0],), indices.shape[-1],
                                         dtype=torch.int32, device=audio.device)
        return audio, feature_lengths * self.config.frame_length


def init_model(checkpoint_path: str | Path, device: str = "cuda", precision: str = "bf16",
               compile: bool = True):  # noqa: A002 - the reference's signature
    """A ready engine from a checkpoint directory (the reference's
    ``init_model``): the LM cast to the precision's dtype (``int8``: bf16,
    then weight-only int8 matmuls, as ``FishTTS`` does) on ``device``.
    Returns ``(engine, engine.generate_long)``; ``compile`` is accepted for
    the signature (the engine captures its decode graphs on first use)."""
    from fish_tts_tpu_torch.engine.generate import GenerationEngine
    from fish_tts_tpu_torch.synthesizer import _DTYPES
    from fish_tts_tpu_torch.utils.quantize import quantize_lm_params

    if precision not in _DTYPES:
        raise ValueError(f"Unknown precision {precision!r}; expected one of bf16, int8, fp16, "
                         "fp32")
    dev = _device(device)
    model = DualARTransformer.from_pretrained(checkpoint_path, device="cpu")
    params = ckpt.to_device(dual_ar.cast_params(model.params, _DTYPES[precision]), dev)
    if precision == "int8":
        params = quantize_lm_params(params)
    engine = GenerationEngine(params, model.config, model.tokenizer)
    return engine, engine.generate_long


def generate_long(*, model, tokenizer=None, text: str, num_samples: int = 1,
                  max_new_tokens: int = 0, top_p: float = 0.8, repetition_penalty: float = 1.1,
                  temperature: float = 0.8, prompt_text: list[str] | str | None = None,
                  prompt_tokens: list[np.ndarray] | np.ndarray | None = None,
                  streaming: bool = False, **_ignored) -> Iterator:
    """Module-level ``generate_long`` with the reference's keywords.
    ``model`` is the :class:`GenerationEngine` that :func:`init_model`
    returns; ``tokenizer`` and ``decode_one_token`` are accepted and unused
    (the engine owns both)."""
    if prompt_text is not None and not isinstance(prompt_text, list):
        prompt_text = [prompt_text]
    if prompt_tokens is not None and not isinstance(prompt_tokens, list):
        prompt_tokens = [prompt_tokens]
    yield from model.generate_long(text, num_samples=num_samples, max_new_tokens=max_new_tokens,
                                   top_p=top_p, repetition_penalty=repetition_penalty,
                                   temperature=temperature, prompt_text=prompt_text,
                                   prompt_tokens=prompt_tokens, streaming=streaming)
