"""Model and engine configuration for the PyTorch/CUDA port.

The port's own copy of ``fish_tts_tpu/config.py``: the same frozen
dataclasses, field names and defaults, so a ``config.json`` or
``vocoder_config.json`` written for one package loads in the other.

``EngineConfig`` keeps every field, ``tp_size`` and ``dp_size`` included.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from pathlib import Path


def find_multiple(n: int, k: int) -> int:
    """Round ``n`` up to the nearest multiple of ``k``."""
    if n % k == 0:
        return n
    return n + k - (n % k)


@dataclass(frozen=True)
class DualARConfig:
    """Configuration of the DualAR text-to-semantic transformer.

    ``fast_*`` fields default to their slow counterparts,
    ``intermediate_size`` defaults to the SwiGLU 2/3*4d rule rounded to a
    multiple of 256, and ``n_local_heads`` (GQA KV heads) defaults to
    ``n_head``.
    """

    model_type: str = "dual_ar"
    vocab_size: int = 32000
    n_layer: int = 32
    n_head: int = 32
    dim: int = 4096
    intermediate_size: int | None = None
    n_local_heads: int = -1
    head_dim: int = 64
    rope_base: float = 10000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 2048
    dropout: float = 0.0
    tie_word_embeddings: bool = True
    attention_qkv_bias: bool = False
    attention_o_bias: bool = False
    attention_qk_norm: bool = False

    codebook_size: int = 160
    num_codebooks: int = 4
    scale_codebook_embeddings: bool = False

    n_fast_layer: int = 4
    fast_dim: int | None = None
    fast_n_head: int | None = None
    fast_n_local_heads: int | None = None
    fast_head_dim: int | None = None
    fast_intermediate_size: int | None = None
    fast_attention_qkv_bias: bool | None = None
    fast_attention_qk_norm: bool | None = None
    fast_attention_o_bias: bool | None = None

    # The residual codebooks decode over the first ``residual_codebook_size``
    # logits of the fast head.
    residual_codebook_size: int = 1024

    def __post_init__(self):
        if self.n_local_heads == -1:
            object.__setattr__(self, "n_local_heads", self.n_head)
        if self.intermediate_size is None:
            hidden = int(2 * (4 * self.dim) / 3)
            object.__setattr__(self, "intermediate_size", find_multiple(hidden, 256))
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.dim // self.n_head)
        for name, fallback in (
            ("fast_dim", self.dim),
            ("fast_n_head", self.n_head),
            ("fast_n_local_heads", self.n_local_heads),
            ("fast_head_dim", self.head_dim),
            ("fast_intermediate_size", self.intermediate_size),
            ("fast_attention_qkv_bias", self.attention_qkv_bias),
            ("fast_attention_qk_norm", self.attention_qk_norm),
            ("fast_attention_o_bias", self.attention_o_bias),
        ):
            if getattr(self, name) is None:
                object.__setattr__(self, name, fallback)

    @property
    def fast_config(self) -> "DualARConfig":
        """A view of this config with the fast-transformer dims in the slow slots."""
        return dataclasses.replace(
            self,
            dim=self.fast_dim,
            n_head=self.fast_n_head,
            n_local_heads=self.fast_n_local_heads,
            head_dim=self.fast_head_dim,
            intermediate_size=self.fast_intermediate_size,
            attention_qkv_bias=self.fast_attention_qkv_bias,
            attention_qk_norm=self.fast_attention_qk_norm,
            attention_o_bias=self.fast_attention_o_bias,
        )

    @staticmethod
    def from_json(path: str | Path) -> "DualARConfig":
        """Load from a checkpoint directory or config.json."""
        path = Path(path)
        if path.is_dir():
            path = path / "config.json"
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
        if data.get("model_type") != "dual_ar":
            raise ValueError(f"Unknown model type: {data.get('model_type')}")
        known = {f.name for f in dataclasses.fields(DualARConfig)}
        return DualARConfig(**{k: v for k, v in data.items() if k in known})


@dataclass(frozen=True)
class VocoderTransformerConfig:
    """Config for the vocoder-internal window-limited transformers.

    ``pos_embed_type`` ``"conformer"`` means position-free attention (the
    learned relative table is allocated but never read).
    """

    block_size: int = 2048
    n_layer: int = 8
    n_head: int = 8
    dim: int = 512
    intermediate_size: int = 1536
    n_local_heads: int = -1
    head_dim: int = 64
    rope_base: float = 10000.0
    norm_eps: float = 1e-5
    channels_first: bool = True
    pos_embed_type: str = "rope"
    max_relative_position: int = 128

    def __post_init__(self):
        if self.n_local_heads == -1:
            object.__setattr__(self, "n_local_heads", self.n_head)


@dataclass(frozen=True)
class VocoderConfig:
    """Config of the DAC-style codec.

    All convs are causal.  ``decoder_transformer_layers`` is accepted and
    ignored: the decoder blocks drop their transformers, so those
    checkpoint weights never load.
    """

    sample_rate: int = 44100
    encoder_dim: int = 64
    encoder_rates: tuple[int, ...] = (2, 4, 8, 8)
    decoder_dim: int = 1536
    decoder_rates: tuple[int, ...] = (8, 8, 4, 2)
    latent_dim: int | None = None
    encoder_transformer_layers: tuple[int, ...] = (0, 0, 0, 4)
    decoder_transformer_layers: tuple[int, ...] = (4, 0, 0, 0)  # dropped

    quantizer_input_dim: int = 1024
    n_residual_codebooks: int = 9
    residual_codebook_size: int = 1024
    semantic_codebook_size: int = 4096
    codebook_dim: int = 8
    downsample_factor: tuple[int, ...] = (2, 2)

    quantizer_transformer: VocoderTransformerConfig = VocoderTransformerConfig(
        block_size=4096, n_layer=8, n_head=16, dim=1024, intermediate_size=3072
    )
    quantizer_window: int = 128
    encoder_window: int = 512

    def __post_init__(self):
        if self.latent_dim is None:
            object.__setattr__(
                self, "latent_dim", self.encoder_dim * (2 ** len(self.encoder_rates))
            )

    @property
    def hop_length(self) -> int:
        h = 1
        for r in self.encoder_rates:
            h *= r
        return h

    @property
    def downsample(self) -> int:
        d = 1
        for f in self.downsample_factor:
            d *= f
        return d

    @property
    def frame_length(self) -> int:
        """Audio samples per semantic token."""
        return self.hop_length * self.downsample

    @property
    def num_codebooks(self) -> int:
        """Total code rows the vocoder consumes (1 semantic + residual)."""
        return 1 + self.n_residual_codebooks

    def to_json(self, path: str | Path) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)

    @staticmethod
    def from_json(path: str | Path) -> "VocoderConfig":
        """Load from a checkpoint directory or ``vocoder_config.json``."""
        path = Path(path)
        if path.is_dir():
            path = path / "vocoder_config.json"
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
        t = data.pop("quantizer_transformer", None)
        known = {f.name for f in dataclasses.fields(VocoderConfig)}
        kw = {
            k: tuple(v) if isinstance(v, list) else v
            for k, v in data.items() if k in known
        }
        if t is not None:
            known_t = {f.name for f in dataclasses.fields(VocoderTransformerConfig)}
            kw["quantizer_transformer"] = VocoderTransformerConfig(
                **{k: v for k, v in t.items() if k in known_t}
            )
        return VocoderConfig(**kw)


@dataclass(frozen=True)
class EngineConfig:
    """Generation-engine knobs.

    - ``prompt_buckets``: prompt lengths are right-padded to the smallest
      bucket.
    - ``decode_chunk`` / ``first_chunk`` / ``batch_chunk``: frames per
      decode call (first call after prefill, streaming, non-streaming).
    - ``kv_bucket_step``: attention reads ``ceil(pos/step)*step`` cache rows.
    - ``rep_penalty_window``: repetition-penalty window in frames.
    - ``sample_top_k``: -1 the sort-free threshold top-p (the sampler
      kernel's), 0 an exact full sort, > 0 a truncated candidate search;
      ``approx_top_k`` asks for an approximate search, which the port runs
      exactly (``engine/sampling.py``).
    - ``fast_kernel``: False keeps every frame on the plain PyTorch route.
    - ``tp_size`` / ``dp_size``: with a product above 1 the engine runs on
      a (dp, tp) device mesh (``parallel/mesh.py``): each weight split over
      ``tp_size`` ranks Megatron-style (``parallel/sharding.py``), the batch
      over ``dp_size`` rows, each row a replica.  On a mesh every kernel is
      off, caches are allocated at the full context and decode runs
      eagerly.
    """

    prompt_buckets: tuple[int, ...] = (64, 128, 256, 512, 1024, 2048)
    decode_chunk: int = 20
    first_chunk: int = 10
    batch_chunk: int = 100
    sample_top_k: int = -1
    approx_top_k: bool = False
    kv_bucket_step: int = 256
    fast_kernel: bool = True
    rep_penalty_window: int = 16
    tp_size: int = 1
    dp_size: int = 1

    def __post_init__(self):
        if self.tp_size < 1 or self.dp_size < 1:
            raise ValueError(f"tp_size={self.tp_size} and dp_size={self.dp_size} must be "
                             "at least 1")


S1_MINI_CONFIG = DualARConfig(
    vocab_size=155776,
    n_layer=28,
    n_head=16,
    n_local_heads=8,
    dim=1024,
    head_dim=64,
    intermediate_size=4096,
    max_seq_len=4096,
    num_codebooks=10,
    codebook_size=4096,
    n_fast_layer=4,
    fast_dim=1024,
    tie_word_embeddings=True,
)

TINY_CONFIG = DualARConfig(
    vocab_size=512,
    n_layer=2,
    n_head=4,
    n_local_heads=2,
    dim=64,
    head_dim=16,
    intermediate_size=128,
    max_seq_len=128,
    num_codebooks=4,
    codebook_size=48,
    residual_codebook_size=24,
    n_fast_layer=2,
    fast_dim=64,
)

TINY_VOCODER_CONFIG = VocoderConfig(
    encoder_dim=4,
    encoder_rates=(2, 4, 8, 8),
    decoder_dim=64,
    decoder_rates=(8, 8, 4, 2),
    encoder_transformer_layers=(0, 0, 0, 1),
    quantizer_input_dim=64,
    n_residual_codebooks=3,
    residual_codebook_size=24,
    semantic_codebook_size=48,
    codebook_dim=4,
    quantizer_transformer=VocoderTransformerConfig(
        block_size=256, n_layer=1, n_head=2, dim=64, intermediate_size=128, head_dim=32
    ),
)
