"""Audio output: float audio to 16-bit mono WAV or raw PCM bytes.

The port's copy of ``to_wav_bytes`` and ``to_pcm_bytes`` from
``fish_tts_tpu/utils/audio.py``, byte for byte the same output.
"""

from __future__ import annotations

import io
import wave

import numpy as np

DEFAULT_SAMPLE_RATE = 44100


def to_wav_bytes(audio: np.ndarray, sample_rate: int = DEFAULT_SAMPLE_RATE) -> bytes:
    """float audio -> 16-bit mono WAV bytes (clipped to [-1, 1])."""
    audio = np.clip(np.asarray(audio, dtype=np.float32), -1.0, 1.0)
    audio_int16 = (audio * 32767).astype(np.int16)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(sample_rate)
        wf.writeframes(audio_int16.tobytes())
    return buf.getvalue()


def to_pcm_bytes(audio: np.ndarray) -> bytes:
    """float audio -> raw int16 PCM bytes (no clipping, as the JAX package)."""
    audio_int16 = (np.asarray(audio, dtype=np.float32) * 32767).astype(np.int16)
    return audio_int16.tobytes()
