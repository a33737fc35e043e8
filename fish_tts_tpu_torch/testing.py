"""Bundles of random weights for ``FishTTS(_testing_bundle=...)``.

- ``make_tiny_bundle``: the tiny config and codec, a byte-level vocabulary
  with a reduced semantic range; CPU-sized, for the tests.
- ``make_s1_mini_bundle``: S1-mini widths and depth with the full-width
  codec and a byte-level vocabulary carrying the full special-token table,
  drawn from a seed on the given device in bf16.

Both write their ``.tiktoken`` vocabulary into a fresh temporary directory.
"""

from __future__ import annotations

import tempfile
from pathlib import Path

import torch

from fish_tts_tpu_torch.config import (
    S1_MINI_CONFIG,
    TINY_CONFIG,
    TINY_VOCODER_CONFIG,
    VocoderConfig,
)
from fish_tts_tpu_torch.models import dual_ar, vocoder
from fish_tts_tpu_torch.models.tokenizer import (
    ALL_SPECIAL_TOKENS,
    FishTokenizer,
    tiny_special_tokens,
    write_tiny_vocab,
)


def _generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(seed)
    return gen


def _byte_tokenizer(specials: list[str]) -> FishTokenizer:
    d = Path(tempfile.mkdtemp(prefix="fish_tts_torch_vocab_"))
    write_tiny_vocab(d / "tokenizer.tiktoken")
    return FishTokenizer(d / "tokenizer.tiktoken", specials)


def make_tiny_bundle(seed: int = 0):
    """(cfg, params, tokenizer, vocoder_cfg, vocoder_params) at tiny size,
    f32 on the CPU."""
    cfg, vcfg = TINY_CONFIG, TINY_VOCODER_CONFIG
    tokenizer = _byte_tokenizer(tiny_special_tokens(cfg.codebook_size))
    params = dual_ar.init_params(_generator(seed, "cpu"), cfg, dtype=torch.float32)
    vparams = vocoder.init_vocoder_params(_generator(seed + 1, "cpu"), vcfg,
                                          dtype=torch.float32)
    return cfg, params, tokenizer, vcfg, vparams


def make_s1_mini_bundle(seed: int = 0, device="cuda", with_vocoder: bool = True):
    """(cfg, params, tokenizer, vocoder_cfg, vocoder_params) at S1-mini
    widths with random bf16 weights on ``device``.  Without
    ``with_vocoder`` the codec parameters are None."""
    cfg, vcfg = S1_MINI_CONFIG, VocoderConfig()
    tokenizer = _byte_tokenizer(ALL_SPECIAL_TOKENS)
    params = dual_ar.init_params(_generator(seed, device), cfg, dtype=torch.bfloat16)
    vparams = None
    if with_vocoder:
        vparams = vocoder.init_vocoder_params(_generator(seed + 1, device), vcfg,
                                              dtype=torch.bfloat16)
    return cfg, params, tokenizer, vcfg, vparams
