"""Model layer: DualAR LM, DAC codec, tokenizer, prompt assembly.

The re-exports are the JAX package's ``fish_tts_tpu.models`` list, the
reference's ``fish_tts.models`` surface.  ``BaseModelArgs`` and
``DualARModelArgs`` both name the one ``DualARConfig``.
"""

from fish_tts_tpu_torch.config import DualARConfig as BaseModelArgs  # noqa: F401
from fish_tts_tpu_torch.config import DualARConfig as DualARModelArgs  # noqa: F401
from fish_tts_tpu_torch.config import VocoderConfig as VocoderModelArgs  # noqa: F401
from fish_tts_tpu_torch.models.api import (  # noqa: F401
    DAC,
    DownsampleResidualVectorQuantize,
    DualARTransformer,
    WindowLimitedTransformer,
    generate_long,
    init_model,
)
from fish_tts_tpu_torch.models.prompt import ContentSequence, TextPart, VQPart  # noqa: F401
from fish_tts_tpu_torch.models.tokenizer import FishTokenizer  # noqa: F401


def __getattr__(name):
    # GenerateResponse lives in the engine layer, which imports this package:
    # resolved lazily so that either side may be imported first
    if name == "GenerateResponse":
        from fish_tts_tpu_torch.engine.generate import GenerateResponse

        return GenerateResponse
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "BaseModelArgs",
    "DualARModelArgs",
    "DualARTransformer",
    "FishTokenizer",
    "DAC",
    "DownsampleResidualVectorQuantize",
    "VocoderModelArgs",
    "WindowLimitedTransformer",
    "init_model",
    "generate_long",
    "GenerateResponse",
    "ContentSequence",
    "TextPart",
    "VQPart",
]
