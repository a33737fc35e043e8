"""fish-tts-tpu-torch: the PyTorch/CUDA port of fish-tts-tpu.

The same text-to-speech pipeline as the JAX package (tokenizer and prompt,
prefill, chunked decode, DAC codec decode, WAV bytes), written in PyTorch
for an NVIDIA GPU.  The decode hot path runs hand-written CUDA kernels
(``csrc/``) built with ``nvcc`` at first use; on CPU tensors every kernel
wrapper runs its plain PyTorch version instead.

Usage:
    from fish_tts_tpu_torch import FishTTS

    tts = FishTTS(model_dir="/path/to/native-checkpoint")  # device="cuda"
    wav = tts.synthesize("Hello world")
"""

from fish_tts_tpu_torch.synthesizer import (  # noqa: F401
    FishTTS,
    VoiceProfile,
    get_instance,
    reset_instance,
)

__version__ = "0.1.0"
__all__ = ["FishTTS", "VoiceProfile", "get_instance", "reset_instance"]
