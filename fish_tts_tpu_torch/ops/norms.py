"""Normalization and elementwise ops (port of ``fish_tts_tpu/ops/norms.py``)."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with f32 inner math, cast back before the gain."""
    xf = x.float()
    normed = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return normed.to(x.dtype) * weight


def vocoder_rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Codec RMSNorm: norms in the input dtype (no f32 upcast)."""
    normed = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return normed.to(x.dtype) * weight


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis with f32 inner math."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    return normed.to(x.dtype) * weight + bias


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Snake activation ``x + sin^2(alpha*x)/alpha``; x is (B, C, T), alpha
    (1, C, 1)."""
    s = torch.sin(alpha * x)
    return x + (s * s) / (alpha + 1e-9)
