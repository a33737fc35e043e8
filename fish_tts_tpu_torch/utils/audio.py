"""Audio I/O: WAV read and write, resampling, raw PCM and WAV headers.

The port's copy of ``read_wav`` (with ``resample`` and ``_fft_resample``),
``to_wav_bytes``, ``to_pcm_bytes``, ``wav_header``,
``streaming_wav_header``, ``transcode_to_wav`` and ``load_audio_bytes``
from ``fish_tts_tpu/utils/audio.py``: 16-bit mono
WAV, float32 in [-1, 1], resampled to 44.1 kHz on read.  Resampling is the
Fourier method of ``scipy.signal.resample`` in numpy alone (the JAX
package's fallback when scipy is absent), computed in float64.
"""

from __future__ import annotations

import io
import shutil
import struct
import subprocess
import wave
from pathlib import Path

import numpy as np

DEFAULT_SAMPLE_RATE = 44100


def _fft_resample(x: np.ndarray, num: int) -> np.ndarray:
    """Fourier-method resampling equivalent to ``scipy.signal.resample``,
    with its Nyquist-bin split and fold for even lengths."""
    n = len(x)
    X = np.fft.rfft(x)
    Y = np.zeros(num // 2 + 1, dtype=X.dtype)
    m = min(num, n)
    nyq = m // 2 + 1
    Y[:nyq] = X[:nyq]
    if m % 2 == 0:  # the shorter spectrum ends in a real Nyquist bin
        if num < n:  # downsampling: fold the discarded conjugate half in
            Y[m // 2] *= 2.0
        elif num > n:  # upsampling: split the Nyquist bin across +/- freqs
            Y[m // 2] *= 0.5
    y = np.fft.irfft(Y, num)
    return (y * (num / n)).astype(np.float32)


def resample(audio: np.ndarray, sr_in: int, sr_out: int = DEFAULT_SAMPLE_RATE) -> np.ndarray:
    """Resample mono float audio from ``sr_in`` to ``sr_out`` (float32 out)."""
    if sr_in == sr_out:
        return audio.astype(np.float32)
    num = int(len(audio) * sr_out / sr_in)
    return _fft_resample(audio.astype(np.float64), num)


def read_wav(audio_bytes: bytes, target_sr: int = DEFAULT_SAMPLE_RATE) -> np.ndarray:
    """WAV bytes (8, 16 or 32-bit, any channel count) -> float32 mono array
    at ``target_sr``."""
    with wave.open(io.BytesIO(audio_bytes), "rb") as wf:
        sample_rate = wf.getframerate()
        n_channels = wf.getnchannels()
        sampwidth = wf.getsampwidth()
        data = wf.readframes(wf.getnframes())

    if sampwidth == 2:
        audio = np.frombuffer(data, dtype=np.int16).astype(np.float32) / 32768.0
    elif sampwidth == 4:
        audio = np.frombuffer(data, dtype=np.int32).astype(np.float32) / 2147483648.0
    elif sampwidth == 1:
        audio = (np.frombuffer(data, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"Unsupported sample width: {sampwidth}")

    if n_channels > 1:
        audio = audio.reshape(-1, n_channels).mean(axis=1)
    return resample(audio, sample_rate, target_sr)


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


def wav_header(sample_rate: int = DEFAULT_SAMPLE_RATE, data_size: int | None = None) -> bytes:
    """44-byte 16-bit mono WAV header.  ``data_size=None`` writes the
    0xFFFFFFFF sizes of a live stream (players read to the end); a concrete
    ``data_size`` writes the sizes of a finished file."""
    riff = 0xFFFFFFFF if data_size is None else 36 + data_size
    data = 0xFFFFFFFF if data_size is None else data_size
    return (b"RIFF" + struct.pack("<I", riff) + b"WAVEfmt "
            + struct.pack("<IHHIIHH", 16, 1, 1, sample_rate, sample_rate * 2, 2, 16)
            + b"data" + struct.pack("<I", data))


def streaming_wav_header(sample_rate: int = DEFAULT_SAMPLE_RATE) -> bytes:
    """Unknown-length (live-stream) WAV header; see :func:`wav_header`."""
    return wav_header(sample_rate, None)


def to_pcm_bytes(audio: np.ndarray) -> bytes:
    """float audio -> raw int16 PCM bytes (no clipping, as the JAX package)."""
    audio_int16 = (np.asarray(audio, dtype=np.float32) * 32767).astype(np.int16)
    return audio_int16.tobytes()


def transcode_to_wav(path, sample_rate: int = DEFAULT_SAMPLE_RATE) -> bytes:
    """Decode any audio file to mono 16-bit WAV bytes through ffmpeg.
    Raises RuntimeError when ffmpeg is missing or fails, with its output."""
    if shutil.which("ffmpeg") is None:
        raise RuntimeError("ffmpeg is required to read non-WAV audio; install it or "
                           "provide a .wav file")
    cmd = ["ffmpeg", "-v", "error", "-i", str(path), "-ac", "1", "-ar", str(sample_rate),
           "-sample_fmt", "s16", "-f", "wav", "pipe:1"]
    proc = subprocess.run(cmd, capture_output=True)
    if proc.returncode != 0:
        detail = proc.stderr.decode(errors="replace").strip()
        raise RuntimeError(f"ffmpeg could not decode {path}: {detail}")
    return proc.stdout


def load_audio_bytes(path, sample_rate: int = DEFAULT_SAMPLE_RATE) -> bytes:
    """A ``.wav`` file's bytes as they are; any other file through ffmpeg."""
    p = Path(path)
    if p.suffix.lower() == ".wav":
        return p.read_bytes()
    return transcode_to_wav(p, sample_rate)
