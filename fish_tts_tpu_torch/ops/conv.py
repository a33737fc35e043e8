"""Causal 1-D convolutions for the codec (port of ``fish_tts_tpu/ops/conv.py``).

The JAX package lowers these to XLA convolutions outside any Pallas kernel;
here they are ``F.conv1d`` / ``F.conv_transpose1d`` with the same padding
and trimming:

- ``causal_conv1d``: left-pad ``eff_kernel - stride`` plus an extra
  right-pad to a whole number of frames,
- ``causal_conv_transpose1d``: full transposed conv, then trim
  ``kernel - stride`` from the right.

Layouts are channels-first ``(B, C, T)``; kernels ``(O, I/groups, K)``,
transposed kernels ``(I, O, K)``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def conv1d(x, w, b=None, stride=1, dilation=1, groups=1, padding=(0, 0)):
    x = F.pad(x.to(w.dtype), padding)
    if stride > 1 and x.device.type == "cpu" and w.dtype in (torch.bfloat16, torch.float16):
        # PyTorch's CPU convolution sums some strided reduced-precision shapes
        # wrongly (the encoder's kernel 16, stride 8 in bf16); there the sums
        # run in float32, as on the card, and round to the dtype once
        return F.conv1d(x.float(), w.float(), None if b is None else b.float(), stride=stride,
                        dilation=dilation, groups=groups).to(w.dtype)
    return F.conv1d(x, w, b, stride=stride, dilation=dilation, groups=groups)


def extra_padding_for_conv1d(length: int, kernel_size: int, stride: int,
                             padding_total: int) -> int:
    """Right padding so the last window is complete."""
    n_frames = (length - kernel_size + padding_total) / stride + 1
    ideal = (math.ceil(n_frames) - 1) * stride + (kernel_size - padding_total)
    return ideal - length


def causal_conv1d(x, w, b=None, stride=1, dilation=1, groups=1):
    k = w.shape[-1]
    eff_k = (k - 1) * dilation + 1
    pad = eff_k - stride
    extra = extra_padding_for_conv1d(x.shape[-1], eff_k, stride, pad)
    return conv1d(x, w, b, stride=stride, dilation=dilation, groups=groups,
                  padding=(pad, extra))


def conv_transpose1d(x, w, b=None, stride=1):
    """Full transposed conv, output length ``(T-1)*stride + K``."""
    return F.conv_transpose1d(x.to(w.dtype), w, b, stride=stride)


def causal_conv_transpose1d(x, w, b=None, stride=1):
    k = w.shape[-1]
    out = conv_transpose1d(x, w, b, stride=stride)
    trim = k - stride
    if trim > 0:
        out = out[..., :-trim]
    return out
