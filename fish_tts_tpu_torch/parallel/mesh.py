"""Device-mesh construction: port of ``fish_tts_tpu/parallel/mesh.py``.

A :class:`Mesh` is a 2-axis grid of ``torch.device``s: ``dp`` rows, each
holding one replica of the LM and decoding its own share of the batch, and
``tp`` ranks per row, each holding a tensor-parallel shard of every weight.
One process drives the whole mesh: every shard and every collective is
explicit (``parallel/sharding.py``, ``parallel/collectives.py``).

A device may appear more than once when the caller passes the list: that is
how one card (or the CPU, which torch sees as one device) holds a tp = 2
mesh, the counterpart of the JAX tests' virtual CPU devices.  Such a mesh
runs the sharding and the reductions, not copies between devices.
"""

from __future__ import annotations

import logging

import torch

logger = logging.getLogger(__name__)


class Mesh:
    """A (dp, tp) grid of devices; ``grid[i][r]`` holds tp rank r of dp row i."""

    def __init__(self, grid: list[list[torch.device]]):
        self.grid = grid

    @property
    def shape(self) -> dict[str, int]:
        return {"dp": len(self.grid), "tp": len(self.grid[0])}

    @property
    def first(self) -> torch.device:
        """The device of rank 0 of row 0: it holds the decode state's small
        per-stream tensors and receives every gathered result."""
        return self.grid[0][0]

    def __repr__(self) -> str:
        return f"Mesh(dp={self.shape['dp']}, tp={self.shape['tp']}, grid={self.grid})"


def visible_devices() -> list[torch.device]:
    """Every CUDA device this process sees."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(tp: int = 1, dp: int | None = None, devices: list | None = None) -> Mesh:
    """Build a (dp, tp) mesh over ``devices`` (default: every visible card).

    ``tp`` is the minor axis: a row's ranks are consecutive devices of the
    list.  ``dp=None`` takes every device.  Raises when ``tp`` does not
    divide the device count (``dp=None``) or ``dp * tp`` exceeds it; warns
    when devices are left idle and logs a line when a device repeats."""
    if tp < 1 or (dp is not None and dp < 1):
        raise ValueError(f"tp={tp} and dp={dp} must be at least 1")
    if devices is None:
        devices = visible_devices()
        if not devices:
            raise ValueError("no CUDA device is visible: pass devices= for a mesh off the card")
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if dp is None:
        if n % tp != 0:
            raise ValueError(f"{n} devices not divisible by tp={tp}")
        dp = n // tp
    if dp * tp > n:
        raise ValueError(f"dp*tp={dp * tp} exceeds {n} devices")
    if dp * tp < n:
        # legitimate (a card kept for the serving codec) but never silent:
        # idle cards cut throughput with no other signal
        logger.warning("mesh (dp=%d, tp=%d) covers %d of %d devices; %d left idle",
                       dp, tp, dp * tp, n, n - dp * tp)
    used = devices[:dp * tp]
    if len(set(used)) < len(used):
        logger.info("mesh (dp=%d, tp=%d) repeats devices %s: it runs the sharding and the "
                    "reductions, not copies between devices", dp, tp, used)
    return Mesh([used[i * tp:(i + 1) * tp] for i in range(dp)])


def single_device_mesh() -> Mesh:
    return make_mesh(tp=1, dp=1)
