"""Rotary position embeddings (port of ``fish_tts_tpu/ops/rope.py``).

The cos/sin table is computed in f32 and stored in bf16; rotation applies
the bf16 values in f32 to interleaved ``(pairs, 2)`` real/imag pairs and
casts back to the input dtype.
"""

from __future__ import annotations

import numpy as np
import torch


def precompute_freqs_cis(seq_len: int, n_elem: int, base: float = 10000.0,
                         dtype=torch.bfloat16, device="cpu") -> torch.Tensor:
    """Return the ``(seq_len, n_elem//2, 2)`` table of (cos, sin) pairs."""
    freqs = 1.0 / (
        base ** (np.arange(0, n_elem, 2)[: n_elem // 2].astype(np.float32) / n_elem)
    )
    t = np.arange(seq_len, dtype=np.float32)
    angles = np.outer(t, freqs)
    table = np.stack([np.cos(angles), np.sin(angles)], axis=-1)
    return torch.from_numpy(table).to(device=device, dtype=dtype)


def apply_rotary_emb(x: torch.Tensor, freqs_cis: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` (B, S, H, D) by a table gathered at the right positions:
    ``(S, D//2, 2)`` shared across the batch or ``(B, S, D//2, 2)``."""
    xf = x.float().reshape(*x.shape[:-1], -1, 2)
    fc = freqs_cis.float()
    if fc.dim() == 3:
        fc = fc.reshape(1, fc.shape[0], 1, fc.shape[1], 2)
    else:
        fc = fc.reshape(fc.shape[0], fc.shape[1], 1, fc.shape[2], 2)
    cos, sin = fc[..., 0], fc[..., 1]
    xr, xi = xf[..., 0], xf[..., 1]
    out = torch.stack([xr * cos - xi * sin, xi * cos + xr * sin], dim=-1)
    return out.reshape(x.shape).to(x.dtype)
