"""Timing helpers of the measurement scripts.

- ``resolve_device``: a script's ``--device`` as a torch device; ``cuda``
  without a card raises (there is no CPU fallback).
- ``device_line``: the card's name and power limit as ``nvidia-smi
  --query-gpu=name,power.limit --format=csv,noheader`` prints them, or
  ``"cpu"``.  Every printout and every record names it.
- ``timed``: the time of one call.  On the card it is the time
  between two CUDA events recorded around the call on the current stream,
  waited for: the device's time, not the host's enqueue.  On the CPU it is
  the host's clock, and the records say ``"device": "cpu"``.
- ``Loop``: a loop of ``iters`` iterations of a body as one call.  On the
  card it runs once eagerly (first-use setup), is captured once in a CUDA
  graph and replayed, so a loop of thousands of small kernels is timed on
  the device and not by the host's launches; a replay adds the launches the
  capture recorded to the kernels' counters, as a ``DecodeGraph`` replay
  does.  A loop that cannot be captured runs eagerly (``how == "eager"``),
  and the script prints its host time beside the device time.  On the CPU
  the loop runs eagerly (``how == "host clock"``).
- ``Chunks``: decode chunks as the engine runs them: on the card one
  ``DecodeGraph`` captured on a state and replayed (the production path),
  on the CPU the eager ``decode.decode_chunk``; ``reset_state`` puts that
  state back to a start position in place (the graph holds its addresses).
- ``lm``: the seeded LM weights the profilers time, at S1-mini width (bf16)
  or the tiny config (f32), int8 on request.
"""

from __future__ import annotations

import functools
import subprocess
import time
from typing import Callable

import torch

from fish_tts_tpu_torch.engine import decode
from fish_tts_tpu_torch.models.dual_ar import make_rope_tables
from fish_tts_tpu_torch.testing import make_s1_mini_bundle, make_tiny_bundle
from fish_tts_tpu_torch.utils.checkpoint import to_device
from fish_tts_tpu_torch.utils.quantize import quantize_lm_params


def resolve_device(name: str) -> torch.device:
    """``--device`` as a torch device; ``cuda`` needs a card."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA device (pass --device cpu for the "
                           "CPU; nothing falls back to it)")
    return dev


@functools.cache
def _smi_lines() -> tuple[str, ...]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return tuple(line.strip() for line in out.strip().splitlines())


def device_line(dev: torch.device) -> str:
    """The card's name and power limit (``nvidia-smi``), or ``"cpu"``."""
    if dev.type != "cuda":
        return "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        lines = _smi_lines()
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(index)}, power limit not read"
    return lines[index] if index < len(lines) else lines[0]


def clock_name(dev: torch.device) -> str:
    """What ``timed`` reads on ``dev``."""
    return "cuda events" if dev.type == "cuda" else "host clock"


def timed(fn: Callable[[], object], dev: torch.device) -> tuple[float, float]:
    """(seconds, host seconds) of one ``fn()``.  Seconds: between CUDA
    events around the call, waited for, on the card; the host's clock on the
    CPU.  Host seconds: until ``fn`` returned (on the card, its enqueue)."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        fn()
        dt = time.perf_counter() - t0
        return dt, dt
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    t0 = time.perf_counter()
    fn()
    host = time.perf_counter() - t0
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3, host


class Loop:
    """``body(i)`` for ``i < iters`` as one call (see the module docstring).
    ``how`` says how a call runs: "cuda graph", "eager" or "host clock";
    ``error`` holds the capture's failure when it is "eager"."""

    def __init__(self, body: Callable[[int], object], iters: int, dev: torch.device):
        self.body, self.iters = body, iters
        self.graph: torch.cuda.CUDAGraph | None = None
        self.error = ""
        self.how = "host clock"
        if dev.type != "cuda":
            return
        self.how = "eager"
        stream = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(stream)
        with torch.no_grad(), torch.cuda.stream(side):
            self._eager()  # first-use setup, outside the capture; its launches count
        stream.wait_stream(side)
        before = decode.launch_counts()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.no_grad(), torch.cuda.graph(graph):
                self._eager()
        except RuntimeError as e:  # an operation the capture refuses
            torch.cuda.synchronize(dev)
            self.error = str(e).splitlines()[0] if str(e) else type(e).__name__
            return
        finally:
            captured = [n - m for n, m in zip(decode.launch_counts(), before)]
            decode.add_launches(-k for k in captured)  # a capture launches nothing
        self._launches = captured
        self.graph = graph
        self.how = "cuda graph"

    def _eager(self) -> None:
        for i in range(self.iters):
            self.body(i)

    @torch.no_grad()
    def __call__(self) -> None:
        if self.graph is None:
            self._eager()
            return
        self.graph.replay()
        decode.add_launches(self._launches)


def free(dev: torch.device) -> None:
    """Return cached device memory between a script's parts."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()


def lm(tiny: bool, dev: torch.device, int8: bool, seed: int = 0):
    """(cfg, params, rope) from ``seed``: the tiny config in f32, or S1-mini
    widths in bf16 drawn on ``dev``; ``int8`` quantizes the LM's matmuls."""
    if tiny:
        cfg, params, *_ = make_tiny_bundle(seed)
        params = to_device(params, dev)
    else:
        cfg, params, *_ = make_s1_mini_bundle(seed, device=dev, with_vocoder=False)
    if int8:
        params = quantize_lm_params(params)
    return cfg, params, make_rope_tables(cfg, device=dev)


def reset_state(state: decode.State, pos: int, step: int, sampling, seed: int) -> decode.State:
    """``state`` in place as fresh at position ``pos`` and noise step
    ``step``, with the sampling columns and the noise keys of ``seed``."""
    decode.reset_state(state)
    state["pos"].fill_(pos)
    state["step"].fill_(step)
    decode.set_sampling(state, *sampling)
    decode.set_noise(state, decode.GumbelNoise(seed, None))
    return state


class Chunks:
    """One call decodes ``frames`` frames on ``state`` with the state's own
    sampling columns and noise keys: a ``DecodeGraph`` replay on the card,
    ``decode.decode_chunk`` on the CPU.  ``options`` are the route's
    (``top_k``, ``fast_kernel``); the graph fixes the route when it is made.
    ``iters`` and ``how`` are a ``Loop``'s, so ``time_loop`` times it per
    frame."""

    def __init__(self, params, cfg, ids, rope, state: decode.State, *, frames: int,
                 kv_bucket: int, skip_done: bool, **options):
        self.args = (params, cfg, ids, rope, state)
        self.frames, self.kv_bucket, self.skip_done = frames, kv_bucket, skip_done
        self.options = options
        self.graph = None
        self.iters, self.how, self.error = frames, "host clock", ""
        if state["frame"].device.type == "cuda":
            self.graph = decode.DecodeGraph(params, cfg, ids, rope, state, kv_bucket=kv_bucket,
                                            skip_done=skip_done, capacity=frames, **options)
            self.how = "decode graph"

    def __call__(self):
        """Returns (frames, emitted) on the device."""
        if self.graph is not None:
            return self.graph.run(self.frames)
        params, cfg, ids, rope, state = self.args
        _, frames, emitted = decode.decode_chunk(
            params, rope, state, None, *state["sampling"], cfg=cfg, ids=ids,
            num_frames=self.frames, kv_bucket=self.kv_bucket, early_exit=self.skip_done,
            **self.options)
        return frames, emitted


def record(label: str, value: float, unit: str, dev: torch.device, how: str = "",
           **extra) -> dict:
    """One profiler row: its label, value and unit, the device it ran on
    (``device_line``), the clock that timed it and how the timed code ran."""
    return {"label": label, "value": value, "unit": unit, "device": device_line(dev),
            "clock": clock_name(dev), "how": how, **extra}


def time_loop(loop: Loop, dev: torch.device, n: int) -> tuple[float, str]:
    """Seconds per iteration over ``n`` calls of ``loop``, and a note for its
    row: empty for a captured loop or on the CPU; for a loop the card ran
    eagerly, that fact, the capture's failure and the host's time per
    iteration."""
    def run():
        for _ in range(n):
            loop()

    s, host = timed(run, dev)
    iters = n * loop.iters
    note = ""
    if loop.how == "eager":
        note = (f"  [eager, not captured: {loop.error}; host {host / iters * 1e3:.3f} "
                f"ms/iteration]")
    return s / iters, note
