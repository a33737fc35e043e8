"""The collectives of the mesh route, as plain functions on tensors.

One process drives every device of a mesh (``parallel/mesh.py``), so a
collective is a loop of copies in a fixed rank order: the result is the same
whether the ranks sit on distinct cards or repeat one device.
"""

from __future__ import annotations

import torch


def broadcast(x: torch.Tensor, devices: list[torch.device]) -> list[torch.Tensor]:
    """``x`` on each of ``devices`` (no copy where it already is)."""
    return [x.to(d) for d in devices]


def reduce_sum(parts: list[torch.Tensor], device: torch.device, dtype: torch.dtype
               ) -> torch.Tensor:
    """The sum of one partial result per rank on ``device``: added in rank
    order in float32 and rounded once to ``dtype`` (a row-parallel product's
    reduction: a tp run then rounds where a one-device run does)."""
    acc = parts[0].to(device, torch.float32)
    for p in parts[1:]:
        acc = acc + p.to(device, torch.float32)
    return acc.to(dtype)


def gather(parts: list[torch.Tensor], dim: int, device: torch.device) -> torch.Tensor:
    """The ranks' slices joined along ``dim`` on ``device``, in rank order
    (a vocabulary- or codebook-sharded head gathered to full width)."""
    return torch.cat([p.to(device) for p in parts], dim=dim)
