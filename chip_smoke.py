#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``fish_tts_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  Phases, each
printing its own lines; any failure raises and the script exits non-zero:

1. card: the card's name and power limit (``nvidia-smi``), torch and CUDA
   versions.
2. build: ``nvcc`` builds the kernels from ``fish_tts_tpu_torch/csrc`` and
   ``g++`` the BPE encoder, both from the checkout's sources.
3. kernels: each kernel at S1-mini shapes against its plain PyTorch version
   on the same inputs on the card: the sampler at B = 1, 4 and 16 on four
   inputs (SAMPLER_CASES: f32 randn x 3 logits; the same rounded to bf16,
   the main path's input, full of ties; top_p 1; integer-valued logits
   whose ties keep the live set above the kernel's capacity); the slow
   stack in SLOW_CASES (B = 1, 4 and 16, its limit; one B = 4 call at the
   edge positions: no live rows, clamped at read_len, off the chunk grid;
   a 1024-row read of a 2048-row cache at positions 661-1000; B = 8 at the
   positions of two prefill groups); the fast decoder at B = 1, 4 and 16
   (its limit); the sampler and the fast decoder at B = 8 with (B, 1)
   sampling columns whose rows differ (PER_ROW), as a batch with
   per-stream parameters gives; the slow stack's head-less variant (an
   untied head) at B = 1, 4 and 16, with the slow stack's checks; the fast
   decoder's "s8" dequant variant at B = 1, 4, 8 and 16 (S8_BATCHES)
   against its own plain version row by quantized row (``check_s8_rows``:
   the kernel's int8 rows and scales, copied out through
   ``fast_decoder.s8_trace``, equal to the plain version's up to a row
   whose values differ by one step at a rounding tie, S8_TIE_MARGIN; the
   positions before it within S8_HELD_TOL of the largest logit, the excused
   ones counted and at most S8_MAX_EXCUSED; every stream bit-equal to the
   kernel on that stream alone), and against the "value" kernel and plain
   version on the same inputs (``s8_against_value``: the kernels' distance
   within REL_TOL of the plain pair's); then at the tiny config on the card
   against the CPU's plain version at S8_TINY_TOL and within 3% of "value"
   (``check_s8_tiny``).  Sampler: two calls bit-equal,
   tokens equal to the plain version's but at knife edges of its own
   numbers (``testing.slow_decision_margins``, counted and printed), at
   most 40 cluster-wide rounds and none at top_p 1; the round counter
   (``sampler_kernel.round_counter``) and, at B = 1, the time by part
   (``sampler_kernel.phase_clock``) are printed.
   Slow stack: two calls on the same inputs bit-equal; hidden state, new K/V
   and logits within 1e-2 of the plain version relative to its largest
   magnitude, layer by layer (the kernels sum in another order, and an
   activation that rounds to the other bf16 neighbour moves a product by
   2^-8), and the whole 28-layer call within STACK_TOL.  The fast decoder:
   two calls on the same inputs bit-equal; per stream, logits within the
   same 1e-2 and codes equal up to the first differing code, which must sit
   on a knife edge of the plain version's own numbers
   (``testing.fast_decision_margins``; the count of knife edges is
   printed).  The slow stack at B = 1 and 16 and the fast decoder at each B
   print their time by phase, from the kernels' barrier clocks.  Median
   times of the kernel and the plain version (CUDA events) beside the least
   time the card could take (bytes over 3.35 TB/s or operations over the
   peak rate of their type, whichever is larger).  Each kernel with its
   skip flag clear gives the same bits as without it; with the flag set it
   returns zeros, as its plain version does, and its time is printed.
   Then the port's A/B entry point of the dequant modes
   (``fish_tts_tpu_torch.scripts.ab_fast_decoder``, AB_ARGS) once, its
   lines printed and its launches checked (path "ab").
   Then the tools phase (``phase_tools``): every measurement script of
   ``fish_tts_tpu_torch/scripts`` once, in process, at S1-mini width with
   short repeats (TOOLS), its weights freed before the next: the sampler
   check (every line OK but at knife edges), the kernel-gate A/B (each row
   the gated-off kernel at 0 launches and each other one per decode frame),
   the KV-bucket A/B (both buckets run), the benchmark at int8 and at bf16
   (a parseable report: three rows whose ``audio_s`` is their frames x 2048
   / 44 100, a first chunk and a three-stream batch) and the five
   profilers, the serving one also with ``--sync`` (every row finite and
   positive), and the one-line bench (``scripts/bench.py``) twice: int8
   with every stage at the JAX bench's settings, and bf16 with its decode
   stage only (``check_bench``: exactly the stages' keys, no fallback or
   failure key, the card's ``nvidia-smi`` line as the device, every number
   finite and positive, ``rtf`` x ``value`` = 44 100 / 2048 x ``batch``
   within their rounding, 200 frames timed, 16 serving slots, the precision
   asked for; the port's claims drift lines are printed, not failed on;
   ``check_bench_launches``: the launches of each bench run, read before
   and after it, are each of the three kernels at int8 and the sampler
   alone at bf16); the three kernels launched (path "tools").
4. graph: at S1-mini width (GRAPH_CASES: B = 1, and B = 4 with two streams
   already done; R = 256 of S = 512), GRAPH_FRAMES frames through the eager
   loop (``decode.decode_chunk``) and through the captured CUDA graph
   (``decode.DecodeGraph``) from equal copies of one state and one noise
   seed: frames, emitted flags and the whole state, KV cache included,
   bit-equal; the device and host time of a live and of a skipped frame.
   Then the tiny config with a forced EOS: the graph on the card against
   the CPU's eager loop, equal frames and integer state.
5. main: first the engine at the tiny config on the card against the same
   engine on the CPU with the same noise (equal codes over 40 frames, for
   one stream and for a batch of three in two prompt buckets with
   per-stream sampling parameters); then
   ``FishTTS(device="cuda", precision="int8")`` with random S1-mini
   weights (full 28-layer widths) and the full-width codec;
   ``synthesize(text, max_tokens=MAX_TOKENS)``, and the same with a
   ``VoiceProfile`` of seeded random codes shaped (10, 661), a cloned
   voice's reference.  Checks the WAV header, the sample count ((frames - 1)
   x 2048) and finite audio; prints frames/s, RTF, ``get_metrics()`` and
   each kernel's launch count in each call, which must be what the call's
   route implies (``decode.route``: a kernel on it launches once per frame,
   the slow stack only in decode; a kernel off it not at all), and checks
   that every decode frame was a graph replay (none eager).  After the
   first call, the convert phase (``phase_convert``): the same weights
   written as the reference's ``model.pth`` (bf16) and ``codec.pth`` (f32,
   weight norm split) into a temporary directory; ``FishTTS`` on it, and on
   the directory ``python -m fish_tts_tpu_torch.scripts.convert_checkpoint
   --verify`` makes of it, each giving the first call's codes and WAV bit
   for bit with the same seed; ``init_model`` on the converted directory
   with the module-level ``generate_long``, its codes equal to the in-memory
   engine's with the same seed; load times, file sizes, coverage reports
   and launches (path "convert").  Then
   the same call on the graph route and on the eager loop, ROUTE_RUNS times
   each in turns plus one profiled call each: frames/s, RTF, the host's
   time per decode frame and the device's busy share of the decode span.

6. float: ``FishTTS(device="cuda", precision="bf16")``, the reference's
   default, at S1-mini width: the same two calls (the sampler kernel once
   per frame, the other two kernels not at all), its decode graph against
   the eager loop at B = 1 (bit-equal, device time per frame, graph nodes
   per frame), both decode routes in turns; then one call each for fp16,
   fp32, int8 with an untied head, int8 with ``sample_top_k`` 0 and 8, and
   int8 with qk-norm and qkv and o biases in both stacks, each with the
   launch counts of its route.

7. stream (on the int8 instance of phase 5 and the bf16 one of phase 6):
   ``set_references`` with the 661-frame profile: the prefix's length, the
   time it took, its KV rows against a full-prompt prefill's (within
   PREFIX_KV_TOL); ``synthesize(references=None)``, which must prefill the
   text alone at the prefix's offset, beside ``references=[profile]``
   (frames/s, launches, graph replays); then ``synthesize_stream`` through
   the prefix and with the explicit reference, in both codec modes: chunks
   of whole int16 frames, 10 then 20 then the rest; codes equal to the
   non-streamed call's with the same seed plus its stripped final frame;
   the stateful stream's PCM within STREAM_PCM_TOL int16 steps of the joint
   decode of the same codes; the route's launches and every decode frame a
   graph replay; time to first audio (median of STREAM_RUNS calls) and the
   whole stream's frames/s; the codec's device time per 20-frame chunk; no
   frame of the phase (B = 1) takes the fast decoder's spread attention
   (``fast_decoder.launches_spread`` unchanged).

8. batch (on the same two instances, after their stream phase):
   ``synthesize_batch`` at B = 1, 4, 8 and 16 (BATCH_SIZES), texts in two
   prompt buckets and per-stream sampling parameters, each B warmed once:
   WAV headers and samples per stream, each kernel launched once per frame
   for the whole batch (and once per prompt group's prefill) on its route,
   every decode frame a graph replay; aggregate frames/s (emitted frames
   summed over the streams, over the call's wall time and over the LM's),
   RTF and peak device memory.  At B = 4: the graph route and the eager
   loop give equal codes; ``synthesize_batch_stream`` in both codec modes
   streams the non-streamed codes plus each stream's final frame, the
   stateful pool's PCM within STREAM_PCM_TOL of each stream's joint
   decode; each stream's time to first audio.

9. serve (on the int8 instance after its batch phase, then on the bf16 one):
   ``tts.serve(slots=...)`` warmed up, then requests submitted in waves
   into the running pool (SERVE_CASES: int8 16 requests in 4 waves over 8
   slots, budgets 40-130; bf16 6 over 4 slots), TEXT and SHORT_TEXT in
   turns, each with its own seed and sampling, one with the 661-frame
   profile as its references (admitted in the same round as requests of
   other prompt buckets), one with priority 1, one cancelled at its first audio.  Each kernel
   launches once per pool decode frame, the sampler and the fast decoder
   also once per admitted request's prefill, and every decode frame is a
   graph replay; the fast decoder's spread attention runs in every pool
   frame (B >= 2) and in no admission prefill (``launches_spread``); every
   graph captured mid-serving leaves the pool's state
   and the chunk in flight as they were.  Each request's codes equal its
   codes served alone in a pool of the same slots, on every route, and its
   solo B = 1 run's or differ first at a knife edge of the solo run's
   numbers (both repeated on the eager loop with every decision recorded,
   ``DecisionLog``); its PCM has frames x 2048 samples within
   STREAM_PCM_TOL of the joint decode; the cancelled request gets no event
   after its cancel.  Prints aggregate frames/s, ``stats()`` of the waved
   requests (time to first frames and queue wait, p50/p95, read before any
   other request runs), device ms per round, graph captures and
   their time, the allocations and peak device memory.  Then on the int8
   instance ``serving.http.make_server`` on loopback: two concurrent
   ``POST /synthesize`` (L16 and WAV) equal to a ``ServeSession``'s PCM,
   ``POST /v1/audio/speech``, ``GET /stats`` and ``/metrics``, ``PUT
   /voices/smoke`` registering phase 5's first WAV as a voice, ``GET
   /voices`` listing it and a ``POST /synthesize`` with it equal to a
   ``ServeSession``'s PCM with the encoded profile, and the driver and
   server stopped.

10. encode and long text (on the int8 instance, between its serve and
   HTTP phases, then after them): ``encode_reference`` of phase 5's first
   WAV against ``dac_encode`` on the CPU in float32 (latent by its largest
   relative error; codes equal per frame up to a first differing book at a
   near tie of the CPU's own float64 similarities, VQ_TIE_MARGIN, counted),
   for the bf16 codec and for the codec cast to float32 on the card, and a
   control (bf16 weights at 4 significant bits) that must break the bf16
   limits; encode times of that WAV and of a synthetic ENCODE_SECONDS one with its peak
   device memory; a ``synthesize`` with the encoded profile.  Then
   ``synthesize_long_stream`` of LONG_TEXT (3 chunks, LONG_TOKENS frames
   each): the route's launches (path "long"), PCM of whole frames, the
   WAV of ``synthesize_long`` after the same reseed equal to that PCM,
   chunk 2 prompted with chunk 1's text and carried frames; with the
   661-frame profile stored, only chunk 1 through the prefix, forked once;
   time to first audio beside ``synthesize_stream``'s.

11. mesh (at the end of phase 5's int8 instance's phases, before phase 6):
   a mesh on the one card, two handles to cuda:0, which exercises the
   sharding and the reductions, not copies between cards.
   ``EngineConfig(tp_size=2)`` at bf16 and int8 against the one-device
   plain route (``fast_kernel=False``): the prompt's prefill hidden state
   and logits within STACK_TOL of the plain version's largest, and
   MESH_FRAMES frames of ``synthesize`` from one seed whose codes equal the
   plain run's up to a first difference at a knife edge of its own numbers
   (``hold_to_plain``: the mesh run's decisions recorded under
   ``DecisionLog``, the plain run's first frames repeated on the eager loop
   under another).  ``EngineConfig(dp_size=2)`` at int8:
   ``synthesize_batch`` of MESH_TEXTS for MESH_DP_FRAMES frames (one prompt
   group, one stream per dp row, each row's draws keyed as its text's solo
   run), each stream held
   the same way against its solo B = 1 plain run.  No kernel launches
   there (path "mesh", all five rows 0).  Then ``serve(slots=8)`` on the
   int8 instance with the pool codec on the LM's stream
   (``vocoder_device=None``) and on a stream of its own
   (``vocoder_device=cuda:0``), MESH_SERVE requests each: every request's
   PCM byte-equal between the two; per round the host wall time and the
   device time of the LM stream and of the codec (CUDA events on each
   stream), the aggregate frames/s (path "vocoder_device").

Then the whole run's wall time, one JSON line of per-kernel records
(main-path shapes, B = 1; the sampler on bf16-rounded logits; ``launches``
those of the first int8 ``synthesize`` call, the head-less slow stack's
those of the untied-head call, the "s8" variant's those of the A/B run,
each read from counts set to 0 just before it; ``launches_by_path`` each
path's launches summed over its checked runs, each run read from its own
zeroed counts: ab (the A/B run), tools (the measurement scripts), main (every ``synthesize`` call of phases
5 and 6), convert (the two loaded instances' calls and the init_model
engine's), stream, batch, serve (int8 and bf16), encode (the call with the
encoded profile), long, mesh (the mesh and plain runs of phase 11, all 0)
and vocoder_device (its two serving runs)) and, last, ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or without the package beside this file, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import re
import statistics
import struct
import subprocess
import sys
import time
import wave
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
SEED = 0
TEXT = "The quick brown fox jumps over the lazy dog, and then it rests in the sun."
MAX_TOKENS = 100
READ_LEN = 256   # the kv bucket a short synthesize reads (EngineConfig.kv_bucket_step)
CACHE_LEN = 512  # the smallest cache allocation (engine.generate.CACHE_FLOOR)
REF_FRAMES = 661  # frames in a shipped voice profile (tests/test_api.py::test_gura_profile_loads)
WINDOW = 16      # EngineConfig.rep_penalty_window
REL_TOL = 1e-2
# The whole 28-layer slow stack against its plain version: once one activation
# rounds to the other bf16 neighbour, the two walk apart by bf16 rounding
# steps, about sqrt(28 layers x 5 rounded activations) x 2^-9 = 2.3e-2 of an
# element; the plain version against itself with float64 sums (printed
# beside it) differs by about 1e-2 at this depth.  So the whole call is held
# at 5e-2 and each layer, on the same input, at REL_TOL.
STACK_TOL = 5e-2
SAMPLING = (0.7, 0.8, 1.1)  # temperature, top_p, repetition penalty
GRAPH_FRAMES = 32  # frames of each decode-graph check
# The decode-graph checks at S1-mini width: (label, B, streams already done).
GRAPH_CASES = (("B=1", 1, ()), ("B=4", 4, (2, 3)))
ROUTE_RUNS = 3  # synthesize calls per decode route (graph, eager) in turns
STREAM_RUNS = 3  # timed synthesize_stream calls per case, after the checked one
# The prefix's KV rows against a full-prompt prefill's: the same plain prefill
# of the same tokens on both sides; where the two prompts pad to other
# buckets the 28-layer stack sums in another order, as STACK_TOL allows.
PREFIX_KV_TOL = 5e-2
# The stateful stream's PCM against the joint decode of the same codes, in
# int16 steps: the codec runs in bf16, and a 20-frame chunk and the joint
# bucket take other cuDNN algorithms and round other sums.  The first card
# run measured up to 408 steps (2.2% of a peak of 18 815; PERF.md, PR 8);
# the bound leaves room for other random weights.  The stream must also be
# as close to the float32 decode as the joint bf16 decode is, within
# STREAM_FP32_RATIO of its error.
STREAM_PCM_TOL = 1024
STREAM_FP32_RATIO = 1.5
FLOAT_PROFILE_TOKENS = 20  # frames of the profiled bf16 calls
# The slow-stack checks: (label, B, cache rows, read_len, positions: a list,
# or a [low, high) range drawn from the seed).
SLOW_CASES = [
    ("B=1", 1, CACHE_LEN, READ_LEN, (READ_LEN // 2, READ_LEN)),
    ("B=4", 4, CACHE_LEN, READ_LEN, (READ_LEN // 2, READ_LEN)),
    ("B=16", 16, CACHE_LEN, READ_LEN, (READ_LEN // 2, READ_LEN)),
    # no live rows, clamped at read_len, and two rows past a 64-row chunk
    ("edge B=4", 4, CACHE_LEN, READ_LEN, [0, READ_LEN + 44, 130, 192]),
    # the depth a voice cloned from a 661-frame reference reaches
    ("long B=1", 1, 2048, 1024, (REF_FRAMES, 1001)),
    # a batch of two prefill groups, SHORT_TEXT's rows and TEXT's, 32 frames in
    ("B=8 two groups", 8, CACHE_LEN, READ_LEN, [57, 57, 57, 57, 120, 120, 120, 120]),
]
SLOW_PHASE_CASES = ("B=1", "B=16")  # the cases that print the kernel's time by phase
HEADLESS = "slow_stack_step (no head)"  # the slow-stack kernel for an untied head
S8 = "fast_decoder_s8"  # the fast decoder's "s8" dequant variant
S8_BATCHES = (1, 4, 8, 16)
S8_PHASE_BATCH = 16  # the B at which the "s8" and "value" phase clocks print side by side
S8_VALUE_TOL = 0.03  # "s8" logits against "value": tests/test_fast_decoder.py's 3% of the largest
# The "s8" kernel against its plain version, row by quantized row
# (testing.s8_decision_margins): a row's int8 values may differ only by one
# step at an x / sc within S8_TIE_MARGIN of a .5 boundary (the two sides'
# f32 norms, softmax and sigmoid differ in the last bits, a few f32 steps of
# x / sc, which is below 127: 7.6e-6 each); the positions before such a
# row are held within S8_HELD_TOL of
# the largest logit (S8_TINY_TOL at the tiny config, the CPU test's bound),
# at most S8_MAX_EXCUSED of them may be excused, and each stream must be
# bit-equal to the kernel on that stream alone.
S8_TIE_MARGIN = 1e-4
S8_HELD_TOL = 1e-5
S8_TINY_TOL = 1e-4
S8_MAX_EXCUSED = 0.5
S8_TINY_BATCHES = (1, 4)
# each path's launches per kernel, summed over its checked runs (each read
# from counts set to 0 just before that run): main, stream, batch, serve
PATH_LAUNCHES: dict[str, dict[str, int]] = {}
# The batch phase: B streams, alternately TEXT (the 128-token prompt bucket)
# and SHORT_TEXT (the 64-token one); per-stream sampling parameters.
BATCH_SIZES = (1, 4, 8, 16)
SHORT_TEXT = "Hello there, how are you today?"
BATCH_EAGER_TOKENS = {"int8": MAX_TOKENS, "bf16": 20}  # frames of the graph-vs-eager call
# The tiny engine's batch on the card against the CPU: three texts in two
# prompt buckets of EngineConfig(prompt_buckets=TINY_BUCKETS).
TINY_TEXTS = ("hello there", "hi", "ok go")
TINY_BUCKETS = (16, 32, 64)

# H100 SXM data sheet (dense): memory rate, bf16 tensor-core rate and f32
# CUDA-core rate.
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12
F32_OPS_PER_S = 67e12


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def time_ms(fn, reps: int, warm: int = 2) -> float:
    """Median device time of ``fn()`` over ``reps`` runs, CUDA events."""
    import torch

    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(nbytes: float, ops: float, ops_rate: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_rate
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def rel_err(got, want) -> tuple[float, float]:
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(want.float().abs().max().item(), 1e-30)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def as_tuple(out) -> tuple:
    """A kernel's outputs as a tuple, without the ones it does not make
    (the head-less slow stack's logits)."""
    return tuple(t for t in out if t is not None) if isinstance(out, tuple) else (out,)


def check_skip_flag(label: str, call, plain, got, dev) -> str:
    """The kernel ``call(skip)`` with its skip flag clear gives ``got`` bit
    for bit; with the flag set it returns at once and its outputs are zeros,
    equal to its plain version's ``plain(skip)``.  Returns a note with the
    skipped call's time (CUDA events, the wrapper's host work included)."""
    import torch

    clear = torch.zeros((), dtype=torch.bool, device=dev)
    on = torch.ones((), dtype=torch.bool, device=dev)
    if not all(torch.equal(a, b) for a, b in zip(as_tuple(call(clear)), as_tuple(got))):
        fail(f"{label}: with the skip flag clear the outputs differ from a call without it")
    skipped, skipped_plain = as_tuple(call(on)), as_tuple(plain(on))
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) and not a.any() for a, b in zip(skipped, skipped_plain)):
        fail(f"{label}: with the skip flag set the outputs are not the plain version's zeros")
    return f"skip flag: clear bit-equal, set -> zeros in {time_ms(lambda: call(on), 50):.4f} ms"


# --- phase 3: kernels against their plain versions ------------------------------


SAMPLER_CASES = ("f32", "bf16", "top_p=1", "ints")
PER_ROW = "per-row columns"  # bf16 logits, (B, 1) sampling columns whose rows differ


def per_row_columns(B: int, dev):
    """(B, 1) temperature, top-p and penalty columns whose rows differ (the
    last row at top-p 1), as a batch with per-stream parameters gives."""
    import torch

    i = torch.arange(B, device=dev, dtype=torch.float32)[:, None]
    return (0.5 + 0.1 * (i % 7), torch.where(i == B - 1, 1.0, 0.6 + 0.05 * (i % 6)),
            1.0 + 0.05 * (i % 5))
SAMPLER_PARTS = ("load + penalty", "softmax exchange", "first pass", "cluster rounds",
                 "argmax of kept rows", "compaction", "rank 0 levels", "final argmax")


def sampler_inputs(B: int, case: str, gen, dev):
    """Seeded inputs of the slow sampler at S1-mini shapes: f32 randn x 3
    logits; the same rounded to bf16, as the main path feeds them (full of
    ties); top_p 1; integer-valued logits whose ties keep the live set above
    the kernel's capacity for every level; bf16 with per-row columns."""
    import torch

    from fish_tts_tpu_torch.engine.decode import gumbel_from_uniform

    V, W = 155776, 11  # S1-mini vocab; decode window column 1+K
    if case == "ints":
        logits = torch.randint(-3, 4, (B, V), generator=gen, device=dev).float()
    else:
        logits = torch.randn((B, V), generator=gen, device=dev) * 3.0
        if case != "f32":
            logits = logits.to(torch.bfloat16).float()
    prev = torch.randint(0, V, (B, W), generator=gen, device=dev, dtype=torch.int32)
    prev[:, :3] = torch.topk(logits, 3, dim=-1).indices.int()  # penalize the leaders
    g = gumbel_from_uniform(torch.rand((B, V), generator=gen, device=dev))
    t, p, r = (torch.full((B, 1), v, device=dev) for v in SAMPLING)
    if case == "top_p=1":
        p.fill_(1.0)
    if case == PER_ROW:
        t, p, r = per_row_columns(B, dev)
    return logits, prev, g, t, p, r


def sampler_parts(args, dev, reps: int = 10) -> list[float]:
    """The kernel's time by part (µs, median over ``reps`` calls), from the
    stamps it writes into ``sampler_kernel.phase_clock`` for stream 0."""
    import torch

    from fish_tts_tpu_torch.ops import sampler_kernel as sk

    B = args[0].shape[0]
    clock = torch.zeros((B, sk.CLOCK_STAMPS), dtype=torch.int64, device=dev)
    sk.phase_clock = clock
    parts = []
    try:
        for _ in range(reps):
            sk.sample_slow(*args)
            torch.cuda.synchronize()
            parts.append(clock[0].diff().double().cpu() / 1e3)
    finally:
        sk.phase_clock = None
    return torch.stack(parts).median(dim=0).values.tolist()


def host_and_drain_us(fn, n: int = 200) -> tuple[float, float]:
    """Per call, µs: the host's time to enqueue ``n`` calls back to back, and
    the time until the device has run them all."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return (t1 - t0) / n * 1e6, (t2 - t0) / n * 1e6


def check_sampler(B: int, case: str, gen, dev):
    import torch

    from fish_tts_tpu_torch.ops import sampler_kernel as sk
    from fish_tts_tpu_torch.testing import slow_decision_margins

    args = sampler_inputs(B, case, gen, dev)
    counter = torch.zeros((B, 3), dtype=torch.int32, device=dev)
    sk.round_counter = counter
    try:
        got = sk.sample_slow(*args)
    finally:
        sk.round_counter = None
    got2 = sk.sample_slow(*args)
    want = sk.sample_slow_plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(got, got2):
        fail(f"sample_slow B={B} {case}: two calls on the same inputs differ")
    m = slow_decision_margins(got, want, *args)
    if m["failures"]:
        fail(f"sample_slow B={B} {case}: " + "; ".join(m["failures"]))
    rounds, live, block = (counter[:, j].tolist() for j in range(3))
    if max(rounds) > sk.BISECT_ITERS or (case == "top_p=1" and max(rounds) > 0):
        fail(f"sample_slow B={B} {case}: cluster rounds {rounds}")
    skip_note = check_skip_flag(f"sample_slow B={B} {case}", lambda f: sk.sample_slow(*args, f),
                                lambda f: sk.sample_slow_plain(*args, f), (got,), dev)
    ms = time_ms(lambda: sk.sample_slow(*args), 50)
    plain_ms = time_ms(lambda: sk.sample_slow_plain(*args), 5)
    # one read of logits and noise plus the window, one write of the ids;
    # per lane the window compares, two exps, the scale and the add (the
    # bisection touches only the live rows, fewer operations than these)
    logits, prev, g, t, p, r = args
    bms, by = bound(nbytes(logits, prev, g, t, p, r) + 4 * B,
                    B * logits.shape[1] * (prev.shape[1] + 5), F32_OPS_PER_S)
    err = (got.long() - want.long()).abs().max().item()
    note = (f"tokens equal but for {m['knife_edges']} knife edge(s) of {m['compared']} rows, "
            f"two calls bit-equal; cluster rounds {rounds}, live rows at compaction {live}, "
            f"block-wide levels {block}; {skip_note}")
    if B == 1:
        parts = sampler_parts(args, dev)
        host, drain = host_and_drain_us(lambda: sk.sample_slow(*args))
        note += ("; by part (us): " + ", ".join(
            f"{name} {us:.2f}" for name, us in zip(SAMPLER_PARTS, parts))
            + f" (sum {sum(parts):.2f}); host enqueue {host:.1f} us per call, "
            f"{drain:.1f} us per call back to back")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, max_abs_err=float(err),
                note=note)


def _qdot_f64(x, w):
    """``slow_stack.qdot`` with float64 sums: bf16(x) @ W^T * s."""
    import torch

    xb = x.to(torch.bfloat16).double()
    return ((xb @ w["q"].double().transpose(0, 1)) * w["s"][:, 0].double()).float()


def check_slow_stack(params, cfg, rope, case, gen, dev):
    import torch

    from fish_tts_tpu_torch.models import dual_ar
    from fish_tts_tpu_torch.ops import slow_stack as ss

    label, B, cache_len, read_len, positions = case
    shape = (cfg.n_layer, B, cfg.n_local_heads, cache_len, cfg.head_dim)
    kv = {k: (torch.randn(shape, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
          for k in ("k", "v")}
    if isinstance(positions, tuple):
        pos = torch.randint(*positions, (B,), generator=gen, device=dev, dtype=torch.int32)
    else:
        pos = torch.tensor(positions, device=dev, dtype=torch.int32)
    ids = dual_ar.TokenIds(cfg.vocab_size - cfg.codebook_size, cfg.vocab_size - 1, 4)
    tokens = torch.randint(0, cfg.codebook_size, (B, 1 + cfg.num_codebooks, 1), generator=gen,
                           device=dev, dtype=torch.int32)
    tokens[:, 0] += ids.semantic_begin  # semantic tokens: the codebook rows count
    x = dual_ar.embed_inputs(params, cfg, ids, tokens)[:, 0].contiguous()

    def kern(skip=None):
        return ss.slow_stack_step(params, cfg, rope, x, kv, pos, read_len=read_len, skip=skip)

    def plain(skip=None):
        return ss.slow_stack_step_plain(params, cfg, rope, x, kv, pos, read_len=read_len,
                                        skip=skip)

    # the whole stack in one call against the plain version
    head = cfg.tie_word_embeddings  # else the head-less variant: no logits
    got = as_tuple(kern())
    got2 = as_tuple(kern())
    want = as_tuple(plain())
    torch.cuda.synchronize()
    if not all(torch.equal(g_, g2) for g_, g2 in zip(got, got2)):
        fail(f"slow_stack_step {label}: two calls on the same inputs differ")
    if len(got) != 3 + head or len(want) != 3 + head:
        fail(f"slow_stack_step {label}: {len(got)} outputs, want {3 + head}")
    full = {}
    for name, g_, w_ in zip(("hidden", "new_k", "new_v", "logits"), got, want):
        if g_.shape != w_.shape:
            fail(f"slow_stack_step {label}: {name} shape {tuple(g_.shape)} != "
                 f"{tuple(w_.shape)}")
        full[name] = rel_err(g_, w_)
        if not full[name][1] <= STACK_TOL:
            fail(f"slow_stack_step {label}: {name} relative error {full[name][1]:.3g} "
                 f"> {STACK_TOL} over {cfg.n_layer} layers")
    # layer by layer: the kernel on one layer's weights and cache against the
    # plain version on the same input (the kernel's own output of the layer
    # before), so rounding differences cannot compound across layers
    one = dataclasses.replace(cfg, n_layer=1)
    h, layer_err = x, 0.0
    for i in range(cfg.n_layer):
        p1 = dict(params, layers=ss.layer(params["layers"], slice(i, i + 1)))
        kv1 = {k: v[i:i + 1] for k, v in kv.items()}
        g1 = ss.slow_stack_step(p1, one, rope, h, kv1, pos, read_len=read_len)
        w1 = ss.slow_stack_step_plain(p1, one, rope, h, kv1, pos, read_len=read_len)
        names = ("hidden", "new_k", "new_v") + (("logits",) if head and i == cfg.n_layer - 1
                                                else ())
        for j, name in enumerate(names):
            rel = rel_err(g1[j], w1[j])[1]
            layer_err = max(layer_err, rel)
            if not rel <= REL_TOL:
                fail(f"slow_stack_step {label} layer {i}: {name} relative error {rel:.3g} "
                     f"> {REL_TOL}")
        h = g1[0][:, 0].contiguous()
    # the yardstick for STACK_TOL: the plain version against itself with its
    # products summed in float64, the bf16 rounding of each activation kept
    with mock.patch.object(ss, "qdot", _qdot_f64):
        want64 = as_tuple(plain())
    self_rel = max(rel_err(w64, w_)[1] for w64, w_ in zip(want64, want))
    skip_note = check_skip_flag(f"slow_stack_step {label}", kern, plain, got, dev)
    ms = time_ms(kern, 20)
    plain_ms = time_ms(plain, 3, warm=1)
    lw = params["layers"]
    weights = [lw[k][part] for k in ("wqkv", "wo", "w1", "w3", "w2") for part in ("q", "s")]
    rows = int(torch.clamp(pos.long(), max=read_len).sum())
    row_bytes = 2 * cfg.n_local_heads * cfg.head_dim * kv["k"].element_size()  # K and V
    head_weights = ((params["norm"], params["embeddings"]["q"], params["embeddings"]["s"])
                    if head else ())
    read = (nbytes(x, pos, *weights, lw["attention_norm"], lw["ffn_norm"], *head_weights)
            + cfg.n_layer * rows * row_bytes)
    written = nbytes(*got)
    n_weights = sum(lw[k]["q"].numel() for k in ("wqkv", "wo", "w1", "w3", "w2"))
    n_weights += params["embeddings"]["q"].numel() if head else 0
    attn_ops = 4 * cfg.n_layer * rows * cfg.n_head * cfg.head_dim
    bms, by = bound(read + written, 2 * B * n_weights + attn_ops, BF16_OPS_PER_S)
    err = max(e[0] for e in full.values())
    note = (f"positions {pos.tolist()}, read_len {read_len}; two calls bit-equal; per layer "
            f"rel <= {layer_err:.2e}; whole stack "
            + ", ".join(f"{k} rel {v[1]:.2e}" for k, v in full.items())
            + f" (plain with float64 sums against plain: rel {self_rel:.2e}); {skip_note}")
    if head and label in SLOW_PHASE_CASES:
        for line in slow_phase_breakdown(kern, cfg, dev):
            print(f"kernel slow_stack_step {label} phases: {line}", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, max_abs_err=err, note=note)


def fast_decoder_spills(log: Path) -> list[str]:
    """Each fast-decoder instantiation's stack frame, spill bytes and
    registers, from the kernels' build log (``ops/kernels.build`` compiles
    with ``-Xptxas -v``), or why there are none."""
    if not log.exists():
        return [f"no ptxas log at {log}"]
    lines, out = log.read_text().splitlines(), []
    for i, line in enumerate(lines):
        m = re.search(r"fast_frame_kernelILi(\d+)ELb(\d)", line)
        if m and "Compiling entry" in line and i + 3 < len(lines):
            regs = re.search(r"Used (\d+) registers", lines[i + 3])
            out.append(f"fast_frame_kernel<MAXB={m.group(1)}, "
                       f"{'s8' if m.group(2) == '1' else 'value'}>: {lines[i + 2].strip()}, "
                       f"{regs.group(1) if regs else '?'} registers")
    return out


def fast_phase_labels(cfg, batch: int, dequant: str = "value") -> list[str]:
    """The fast-decoder kernel's phases at ``batch`` streams in ``dequant``
    mode, one per grid-wide barrier, in order (csrc/fast_decoder.cu): the
    batched "value" instantiations (B >= 2) spread the attention over the
    grid in a phase of its own, before W_o; B = 1 and "s8" keep it with W_o."""
    spread = batch >= 2 and dequant != "s8"
    attention = ["attention", "W_o + residual"] if spread else ["attention + W_o"]
    labels = []
    for pos in range(cfg.num_codebooks):
        for layer in range(cfg.n_fast_layer):
            if pos == 0 and layer == cfg.n_fast_layer - 1:
                labels += ["RMSNorm + W_qkv", "cache row"]  # position 0's last layer
                break
            labels += ["RMSNorm + W_qkv", *attention, "RMSNorm + W_1/W_3", "W_2"]
        if pos > 0:
            labels += ["fast_norm + head", "sampling"]
    return labels


def slow_phase_labels(cfg) -> list[str]:
    """The slow-stack kernel's phases, one per grid-wide barrier, in order
    (csrc/slow_stack.cu; the last barrier runs only with the clock on)."""
    layer = ["RMSNorm + W_qkv", "attention", "W_o + residual", "RMSNorm + W_1/W_3",
             "W_2 + residual"]
    return layer * cfg.n_layer + ["final norm + head"]


def phase_breakdown(kern, module, labels: list[str], dev,
                    sums: dict | None = None) -> list[str]:
    """One call of a persistent kernel with its barrier clock
    (``module.phase_clock``) on.  Per phase: from the first block leaving
    the barrier before it to the last block arriving at its own (the
    phase's span), then from that last arrival to the last departure (the
    barrier's release), summed over the call; with ``sums``, also filled
    with label -> [count, span us, release us]."""
    import torch

    from fish_tts_tpu_torch.ops import kernels

    n = len(labels)
    clock = torch.zeros((module.BLOCKS_PER_SM * kernels.num_sms(dev), 1 + 2 * n),
                        dtype=torch.int64, device=dev)
    module.phase_clock = clock
    try:
        kern()
        kern()
        torch.cuda.synchronize()
    finally:
        module.phase_clock = None
    c = clock[clock[:, 0] > 0].double().cpu()
    start, arrive, leave = c[:, 0], c[:, 1::2], c[:, 2::2]
    prev_leave = torch.cat([start[:, None], leave[:, :-1]], dim=1)
    span = (arrive.max(dim=0).values - prev_leave.min(dim=0).values) / 1e3
    release = (leave.max(dim=0).values - arrive.max(dim=0).values) / 1e3
    total = (leave.max() - start.min()).item() / 1e3
    sums = {} if sums is None else sums
    for i, label in enumerate(labels):
        row = sums.setdefault(label, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += span[i].item()
        row[2] += release[i].item()
    lines = [f"{c.shape[0]} blocks, {n} barriers, {total:.1f} us from the first start "
             f"to the last barrier"]
    for label, (count, sp, rel) in sums.items():
        lines.append(f"{label:24s} x{count:3d}: span {sp:8.1f} us ({sp / count:6.2f} each), "
                     f"release {rel:7.1f} us ({rel / count:5.2f} each)")
    rel_all = release.sum().item()
    lines.append(f"{'barrier releases':24s} x{n:3d}: {rel_all:8.1f} us ({rel_all / n:5.2f} each)")
    return lines


def fast_phase_breakdown(kern, cfg, dev, batch: int, sums: dict | None = None,
                         dequant: str = "value") -> list[str]:
    from fish_tts_tpu_torch.ops import fast_decoder as fd

    return phase_breakdown(kern, fd, fast_phase_labels(cfg, batch, dequant), dev, sums)


def slow_phase_breakdown(kern, cfg, dev) -> list[str]:
    from fish_tts_tpu_torch.ops import slow_stack as ss

    return phase_breakdown(kern, ss, slow_phase_labels(cfg), dev)


def fast_inputs(cfg, B: int, gen, dev, per_row: bool = False):
    """Seeded inputs of the fast decoder at the main path's shapes, with
    sampling columns whose rows differ when ``per_row``."""
    import torch

    from fish_tts_tpu_torch.engine.decode import gumbel_from_uniform

    K, Vr = cfg.num_codebooks, cfg.residual_codebook_size
    h = (torch.randn((B, cfg.fast_dim), generator=gen, device=dev) * 0.5).to(torch.bfloat16)
    a0 = torch.randint(0, cfg.codebook_size, (B,), generator=gen, device=dev,
                       dtype=torch.int32)
    prev = torch.randint(0, Vr, (B, K - 1, WINDOW), generator=gen, device=dev,
                         dtype=torch.int32)
    g = gumbel_from_uniform(torch.rand((B, K - 1, Vr), generator=gen, device=dev))
    t, p, r = (torch.full((B, 1), v, device=dev) for v in SAMPLING)
    if per_row:
        t, p, r = per_row_columns(B, dev)
    return h, a0, prev, g, t, p, r


def s8_against_value(kernel, plain, limit: float | None = None) -> str:
    """The "s8" logits against the "value" logits on the same inputs, for
    the kernels (``kernel``: (codes_s8, logits_s8, codes_v, logits_v)) and
    for the plain versions (``plain``, the same), per stream up to and
    including the first position where either pair's codes differ (later
    positions embed other codes), as a share of the value logits' largest
    magnitude.  The kernels' distance must be within REL_TOL of the plain
    pair's on the same inputs, and within ``limit`` when it is given; its
    yes/no against S8_VALUE_TOL is printed (the reference's own "s8" mode
    sits further than that from "value" at S1-mini width).  Returns a note."""
    cs_k, ls_k, cv_k, lv_k = kernel
    cs_p, ls_p, cv_p, lv_p = plain
    dev_k = dev_p = 0.0
    compared = 0
    for b in range(cv_k.shape[0]):
        diff = ((cs_k[b] != cv_k[b]).cpu() | (cs_p[b] != cv_p[b]).cpu()).nonzero()
        n = int(diff[0]) + 1 if len(diff) else cv_k.shape[1]
        dev_k = max(dev_k, (ls_k[b, :n] - lv_k[b, :n]).abs().max().item())
        dev_p = max(dev_p, (ls_p[b, :n] - lv_p[b, :n].to(ls_p.device)).abs().max().item())
        compared += n
    dev_k /= lv_k.abs().max().item()
    dev_p /= lv_p.abs().max().item()
    if not abs(dev_k - dev_p) <= REL_TOL or (limit is not None and not dev_k <= limit):
        fail(f"{S8}: logits {dev_k:.4f} of the value kernel's largest from them, the plain "
             f"versions {dev_p:.4f} (at most {REL_TOL} apart"
             + (f", and within {limit})" if limit is not None else ")"))
    return (f"against value: kernels {dev_k:.4f} of the largest logit apart, plain versions "
            f"{dev_p:.4f}, over {compared} positions (within {REL_TOL} of each other; within "
            f"{S8_VALUE_TOL}: {'yes' if dev_k <= S8_VALUE_TOL else 'no'}), codes equal at "
            f"{int((cs_k == cv_k).sum())} of {cs_k.numel()}; ")


def check_s8_rows(params, cfg, rope, args, codes, logits, label: str, held_tol: float,
                  plain_params=None, plain_rope=None):
    """The "s8" kernel's call on ``args`` (h, a0, prev, g, t, p, r), which
    gave (``codes``, ``logits``), against its plain version, row by quantized
    row (:func:`testing.s8_decision_margins`: a differing row only one step
    at a tie, S8_TIE_MARGIN; earlier positions within ``held_tol`` of the
    largest logit; the excused positions counted, for
    :func:`gate_s8_excused`), the plain version run with
    ``plain_params``/``plain_rope`` on their device when given; and every
    stream bit-equal to the kernel on that stream alone.  Returns (margins,
    plain codes, plain logits, a note)."""
    import torch

    from fish_tts_tpu_torch.ops import fast_decoder as fd
    from fish_tts_tpu_torch.testing import s8_decision_margins, s8_plain_trace

    B, dev = codes.shape[0], codes.device
    for b in range(B if B > 1 else 0):
        alone = fd.fast_decode_frame(params, cfg, rope, *(a[b:b + 1] for a in args),
                                     window=WINDOW, dequant="s8")
        if not (torch.equal(alone[0], codes[b:b + 1]) and torch.equal(alone[1], logits[b:b + 1])):
            fail(f"{S8} {label}: stream {b} differs from the kernel on that stream alone")
    layout = fd.s8_trace_layout(cfg)
    rows = torch.zeros((len(layout), B, fd.s8_trace_width(cfg)), dtype=torch.int8, device=dev)
    scales = torch.zeros((len(layout), B), device=dev)
    fd.s8_trace = (rows, scales)
    try:
        traced = fd.fast_decode_frame(params, cfg, rope, *args, window=WINDOW, dequant="s8")
    finally:
        fd.s8_trace = None
    if not (torch.equal(traced[0], codes) and torch.equal(traced[1], logits)):
        fail(f"{S8} {label}: the traced call differs from the untraced one")
    pdev = dev if plain_params is None else plain_rope.device
    with s8_plain_trace() as plain_rows:
        codes_p, logits_p = fd.fast_decode_frame_plain(
            plain_params or params, cfg, rope if plain_rope is None else plain_rope,
            *(a.to(pdev) for a in args), window=WINDOW, dequant="s8")
    tol = held_tol * logits_p.abs().max().item()
    h, a0, prev, g, t, p, r = args
    m = s8_decision_margins(cfg, codes, codes_p, logits, logits_p, g, t, p, tol, rows, scales,
                            plain_rows, S8_TIE_MARGIN)
    if m["failures"]:
        fail(f"{S8} {label}: " + "; ".join(m["failures"][:8]))
    m["positions"] = codes.numel()
    wit = "; ".join(f"stream {b} row {t} {key}: {n} value(s) one step apart at tie distance "
                    f"<= {d:.3g}" for b, t, key, n, d in m["witnesses"])
    note = (f"every stream bit-equal to the kernel on it alone; {len(layout)} quantized rows a "
            f"stream against the plain version's: scales within {m['scale_err']:.2g}, "
            f"{len(m['witnesses'])} stream(s) with a step at a tie (margin {S8_TIE_MARGIN}"
            + (f": {wit}" if wit else "") + f"), {m['excused']} of {codes.numel()} positions "
            f"excused from there on, {m['compared']} held within {tol:.3g} ({held_tol} of the "
            f"largest; max abs err {m['max_abs_err']:.3g}); ")
    return m, codes_p, logits_p, note


def gate_s8_excused(label: str, margins: list[dict]) -> str:
    """At most S8_MAX_EXCUSED of all the positions of ``margins`` (from
    :func:`check_s8_rows`) excused.  Returns a note."""
    excused = sum(m["excused"] for m in margins)
    positions = sum(m["positions"] for m in margins)
    if not excused <= S8_MAX_EXCUSED * positions:
        fail(f"{S8} {label}: {excused} of {positions} positions excused (at most "
             f"{S8_MAX_EXCUSED:.0%})")
    return (f"{S8} {label}: {excused} of {positions} positions excused after a step at a tie "
            f"(at most {S8_MAX_EXCUSED:.0%})")


def check_s8_tiny(dev) -> None:
    """The "s8" kernel at the tiny config (int8 f32 weights) on the card
    against its plain version on the CPU, which the CPU tests hold against
    the JAX package: :func:`check_s8_rows` at S8_TINY_TOL, and within
    S8_VALUE_TOL of the "value" kernel (the JAX test's bound at its tiny
    config), at B = S8_TINY_BATCHES; at most S8_MAX_EXCUSED of all their
    positions excused."""
    import torch

    from fish_tts_tpu_torch.models.dual_ar import make_rope_tables
    from fish_tts_tpu_torch.ops import fast_decoder as fd
    from fish_tts_tpu_torch.testing import make_tiny_bundle
    from fish_tts_tpu_torch.utils.checkpoint import to_device
    from fish_tts_tpu_torch.utils.quantize import quantize_lm_params

    cfg, params, *_ = make_tiny_bundle(SEED)
    params = quantize_lm_params(params)
    card = to_device(params, dev)
    rope, rope_card = make_rope_tables(cfg)["fast"], make_rope_tables(cfg, device=dev)["fast"]
    if not fd.supports(cfg, card, max(S8_TINY_BATCHES), WINDOW, dequant="s8"):
        fail(f"{S8} tiny: the kernel does not support the tiny config")
    gen = torch.Generator().manual_seed(SEED + 11)
    margins = []
    for B in S8_TINY_BATCHES:
        args = tuple(a.to(dev) for a in fast_inputs(cfg, B, gen, "cpu"))
        codes, logits = fd.fast_decode_frame(card, cfg, rope_card, *args, window=WINDOW,
                                             dequant="s8")
        m, codes_p, logits_p, note = check_s8_rows(card, cfg, rope_card, args, codes, logits,
                                                   f"tiny B={B}", S8_TINY_TOL, params, rope)
        margins.append(m)
        value = fd.fast_decode_frame(card, cfg, rope_card, *args, window=WINDOW)
        value_p = fd.fast_decode_frame_plain(params, cfg, rope, *(a.cpu() for a in args),
                                             window=WINDOW)
        note += s8_against_value((codes, logits, *value), (codes_p, logits_p, *value_p),
                                 limit=S8_VALUE_TOL)
        print(f"kernel {S8} tiny B={B} on the card against the CPU's plain version: {note}",
              flush=True)
    print(f"kernel {gate_s8_excused('tiny', margins)}", flush=True)


def check_fast_decoder(params, cfg, rope, B: int, gen, dev, per_row: bool = False,
                       dequant: str = "value"):
    """The fast decoder in ``dequant`` mode against its plain version in the
    same mode; the "s8" variant also against the "value" kernel."""
    import torch

    from fish_tts_tpu_torch.ops import fast_decoder as fd
    from fish_tts_tpu_torch.testing import fast_decision_margins

    K, Vr = cfg.num_codebooks, cfg.residual_codebook_size
    h, a0, prev, g, t, p, r = fast_inputs(cfg, B, gen, dev, per_row)
    args = (params, cfg, rope, h, a0, prev, g, t, p, r)
    name = S8 if dequant == "s8" else "fast_decode_frame"

    def kern(skip=None):
        return fd.fast_decode_frame(*args, window=WINDOW, skip=skip, dequant=dequant)

    def plain(skip=None):
        return fd.fast_decode_frame_plain(*args, window=WINDOW, skip=skip, dequant=dequant)

    codes, logits = kern()
    codes2, logits2 = kern()
    torch.cuda.synchronize()
    if not (torch.equal(codes, codes2) and torch.equal(logits, logits2)):
        fail(f"{name} B={B}: two calls on the same inputs differ")
    value_note = ""
    if dequant == "s8":
        m, codes_p, logits_p, value_note = check_s8_rows(
            params, cfg, rope, (h, a0, prev, g, t, p, r), codes, logits, f"B={B}", S8_HELD_TOL)
        tol = S8_HELD_TOL * logits_p.abs().max().item()
        value_note += s8_against_value(
            (codes, logits, *fd.fast_decode_frame(*args, window=WINDOW)),
            (codes_p, logits_p, *fd.fast_decode_frame_plain(*args, window=WINDOW)))
    else:
        codes_p, logits_p = plain()
        tol = REL_TOL * logits_p.abs().max().item()
        m = fast_decision_margins(codes, codes_p, logits, logits_p, g, t, p, tol)
        if m["failures"]:
            fail(f"{name} B={B}: " + "; ".join(m["failures"]))
    skip_note = check_skip_flag(f"{name} B={B}", kern, plain, (codes, logits), dev)
    ms = time_ms(kern, 20)
    plain_ms = time_ms(plain, 3, warm=1)
    fl = params["fast_layers"]
    weights = [fl[k][part] for k in ("wqkv", "wo", "w1", "w3", "w2") for part in ("q", "s")]
    head_rows = params["fast_output"]["q"][:Vr]
    emb_row = params["fast_embeddings"]["q"].shape[1] + 4  # one int8 row and its scale
    read = (nbytes(h, a0, prev, g, t, p, r, *weights, fl["attention_norm"], fl["ffn_norm"],
                   params["fast_norm"], head_rows) + 4 * Vr
            + B * (K - 1) * emb_row)
    written = nbytes(codes, logits)
    n_weights = sum(fl[k]["q"].numel() for k in ("wqkv", "wo", "w1", "w3", "w2"))
    ops = (2 * B * K * n_weights + 2 * B * (K - 1) * head_rows.numel()
           + 2 * B * (K - 1) * Vr * Vr)  # the pairwise top-p compares and adds
    # the products at the rate of their operands' type: bf16 x int8 on the
    # bf16 tensor cores, s8 x s8 at the int8 rate
    bms, by = bound(read + written, ops, INT8_OPS_PER_S if dequant == "s8" else BF16_OPS_PER_S)
    # the bound if the layers stream from device memory once per position
    streamed_ms = (read + (K - 1) * nbytes(*weights) + written) / HBM_BYTES_PER_S * 1e3
    phases: dict = {}
    if not per_row:
        for line in fast_phase_breakdown(kern, cfg, dev, B, phases, dequant):
            print(f"kernel {name} B={B} phases: {line}", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                max_abs_err=m["max_abs_err"], margins=m, phases=phases,
                note=(f"codes equal but for {m['knife_edges']} knife edge(s), two calls "
                      f"bit-equal, logits max abs err {m['max_abs_err']:.3g} "
                      f"(tol {tol:.3g}) over {m['compared']} positions; {value_note}"
                      f"streamed-per-position bound {streamed_ms:.4f} ms; {skip_note}"))


KERNELS = [
    ("sample_slow", "fish_tts_tpu_torch/csrc/sampler.cu",
     "fish_tts_tpu/ops/sampler_kernel.py:138"),
    ("slow_stack_step", "fish_tts_tpu_torch/csrc/slow_stack.cu",
     "fish_tts_tpu/ops/slow_stack.py:520"),
    ("fast_decode_frame", "fish_tts_tpu_torch/csrc/fast_decoder.cu",
     "fish_tts_tpu/ops/fast_decoder.py:686"),
    # the variant for an untied head (the JAX kernel's with_head = False, :405, :544)
    (HEADLESS, "fish_tts_tpu_torch/csrc/slow_stack.cu", "fish_tts_tpu/ops/slow_stack.py:520"),
    # the "s8" dequant variant (the JAX kernel's dequant="s8", :98, :239-262)
    (S8, "fish_tts_tpu_torch/csrc/fast_decoder.cu", "fish_tts_tpu/ops/fast_decoder.py:686"),
]


def s8_beside_value(results: dict) -> None:
    """The "s8" kernel's time beside the "value" kernel's from the same run
    at each B of S8_BATCHES (B = 8: the value kernel's per-row case), with
    their ratio; at S8_PHASE_BATCH their phase clocks side by side."""
    value = results["fast_decode_frame"]
    for B in S8_BATCHES:
        label = f"B={B}" if f"B={B}" in value else f"B={B} {PER_ROW}"
        s, v = results[S8][f"B={B}"]["ms"], value[label]["ms"]
        print(f"kernel {S8} B={B} beside fast_decode_frame {label}: s8 {s:.4f} ms, value "
              f"{v:.4f} ms, s8/value {s / v:.3f}", flush=True)
    B = S8_PHASE_BATCH
    ps, pv = results[S8][f"B={B}"]["phases"], value[f"B={B}"]["phases"]
    for label, (n, span_v, rel_v) in pv.items():
        if label not in ps:  # the value kernel's spread attention and its W_o
            print(f"kernel {S8} B={B} phases beside value: {label:24s} x{n:3d}: span value "
                  f"{span_v:8.1f} us ({span_v / n:6.2f} each), value only; release value "
                  f"{rel_v:7.1f} us", flush=True)
            continue
        _, span_s, rel_s = ps[label]
        print(f"kernel {S8} B={B} phases beside value: {label:24s} x{n:3d}: span value "
              f"{span_v:8.1f} us ({span_v / n:6.2f} each), s8 {span_s:8.1f} us "
              f"({span_s / n:6.2f} each), s8/value {span_s / span_v:5.2f}; release value "
              f"{rel_v:7.1f}, s8 {rel_s:7.1f} us", flush=True)
    for label in ps.keys() - pv.keys():
        n, span_s, rel_s = ps[label]
        print(f"kernel {S8} B={B} phases beside value: {label:24s} x{n:3d}: span s8 "
              f"{span_s:8.1f} us ({span_s / n:6.2f} each), s8 only; release s8 "
              f"{rel_s:7.1f} us", flush=True)


def phase_kernels(dev, batches=(1, 4, 16), fast_batches=(1, 4, 16), slow_cases=SLOW_CASES):
    import torch

    from fish_tts_tpu_torch.models.dual_ar import make_rope_tables
    from fish_tts_tpu_torch.testing import make_s1_mini_bundle
    from fish_tts_tpu_torch.utils.quantize import quantize_lm_params

    cfg, params, *_ = make_s1_mini_bundle(SEED, device=dev, with_vocoder=False)
    params = quantize_lm_params(params)
    rope = make_rope_tables(cfg, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 7)
    results = {name: {} for name, _, _ in KERNELS}

    def report(name, label, row):
        print(f"kernel {name} {label}: {row['note']}; kernel {row['ms']:.4f} ms, "
              f"plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']})", flush=True)
        results[name][label] = row

    for B in batches:
        for case in SAMPLER_CASES:
            report("sample_slow", f"B={B} {case}", check_sampler(B, case, gen, dev))
    # a batch's size the checks above skip, with per-stream sampling columns
    report("sample_slow", f"B=8 {PER_ROW}", check_sampler(8, PER_ROW, gen, dev))
    results["sample_slow"]["B=1"] = results["sample_slow"]["B=1 bf16"]  # the main path's input
    for case in slow_cases:
        report("slow_stack_step", case[0], check_slow_stack(params, cfg, rope["slow"], case,
                                                            gen, dev))
    for B in fast_batches:
        report("fast_decode_frame", f"B={B}",
               check_fast_decoder(params, cfg, rope["fast"], B, gen, dev))
    report("fast_decode_frame", f"B=8 {PER_ROW}",
           check_fast_decoder(params, cfg, rope["fast"], 8, gen, dev, per_row=True))
    for B in S8_BATCHES:
        report(S8, f"B={B}", check_fast_decoder(params, cfg, rope["fast"], B, gen, dev,
                                                dequant="s8"))
    print("kernel " + gate_s8_excused(f"B={'/'.join(map(str, S8_BATCHES))}", [
        results[S8][f"B={B}"]["margins"] for B in S8_BATCHES]), flush=True)
    s8_beside_value(results)
    check_s8_tiny(dev)
    untied = dataclasses.replace(cfg, tie_word_embeddings=False)
    for case in slow_cases[:3]:  # B = 1, 4, 16
        report(HEADLESS, case[0], check_slow_stack(params, untied, rope["slow"], case, gen, dev))
    del params
    torch.cuda.empty_cache()
    return results


AB_ARGS = ("-b", "1", "8", "16", "-n", "3")


def phase_ab() -> None:
    """The port's A/B entry point of the fast decoder's dequant modes
    (``python -m fish_tts_tpu_torch.scripts.ab_fast_decoder``) once, with
    AB_ARGS, its lines printed; its launches, read from counts set to 0
    just before it, must be one per frame it ran, "value" and "scratch" on
    the "value" variant and "s8" on its own (the path "ab")."""
    import torch

    from fish_tts_tpu_torch.scripts import ab_fast_decoder as ab

    zero_counts()
    t = time.perf_counter()
    records = ab.main(list(AB_ARGS))
    torch.cuda.synchronize()
    launches = kernel_counts()
    batches = AB_ARGS[AB_ARGS.index("-b") + 1:AB_ARGS.index("-n")]
    runs = len(batches) * (1 + int(AB_ARGS[-1])) * ab.FRAMES  # one warm-up run each
    want = {"sample_slow": 0, "slow_stack_step": 0, HEADLESS: 0,
            "fast_decode_frame": 2 * runs, S8: runs}
    if launches != want or len(records) != 3 * len(batches):
        fail(f"ab: {len(records)} lines, kernel launches {launches}, want {want}")
    tally("ab", launches)
    print(f"ab: {len(records)} lines in {time.perf_counter() - t:.1f} s; kernel launches "
          f"{json.dumps(launches)}", flush=True)


# The measurement scripts (``python -m fish_tts_tpu_torch.scripts.<name>``) the
# tools phase runs, with their arguments: S1-mini widths, short repeats.
TOOLS = (
    ("verify_sampler", ()),
    ("ab_kernel_gates", ("--chunks", "2")),
    ("ab_kvbucket", ("--pos", "130", "--buckets", "512", "256", "--chunks", "2")),
    ("benchmark", ("--random-s1", "--json", "--precision", "int8", "--max-tokens", "200")),
    ("benchmark", ("--random-s1", "--json", "--precision", "bf16", "--max-tokens", "100")),
    ("profile_decode", ("-n", "3")),
    ("profile_batch", ("-b", "8", "--kernels", "-n", "3")),
    ("profile_slow_parts", ("-n", "3")),
    ("profile_vocoder", ("-n", "2")),
    ("profile_serving", ("--slots", "8", "--requests", "16", "--budget", "100")),
    ("profile_serving", ("--slots", "8", "--requests", "16", "--budget", "100", "--sync")),
    ("bench", ()),
    ("bench", ("--bf16", "--no-ttfa", "--aggregate-batch", "0")),
)
# The keys of the bench's line (the JAX bench.py's): its decode stage and the
# user path's stages (the aggregate stage adds one per batch size).
BENCH_DECODE_KEYS = {
    "metric", "value", "unit", "vs_baseline", "rtf", "batch", "prefill_ms", "frames_timed",
    "compile_s", "init_s", "init_compile_s", "init_materialize_s", "platform_first_op_s",
    "init_build_s", "init_head_s", "precision", "device", "hbm_gb"}
BENCH_USER_KEYS = {
    "ttfa_ms", "ttfa_max_ms", "vocoder_frames_per_sec", "rtf_e2e", "serve_tok_per_sec",
    "serve_slots", "serve_passes", "ttfa_busy_ms", "ttfa_busy_max_ms",
    "serve_audio_tok_per_sec", "serve_audio_x_realtime", "serve_audio_passes",
    "ttfa_audio_busy_ms"}
# first-use costs, rounded to 0.1 s: 0.0 once the kernels are built and the
# context is up, and init_head_s always (the port prepares no head)
BENCH_MAY_BE_ZERO = {"compile_s", "init_s", "init_compile_s", "init_materialize_s",
                     "platform_first_op_s", "init_build_s", "init_head_s"}
GATE_KERNELS = {"sampler kernel OFF": "sample_slow", "fast-decoder kernel OFF": "fast_decode_frame",
                "slow-stack kernel OFF": "slow_stack_step"}


def check_gates(records, chunks: int) -> str:
    """Each gate row: its gated-off kernel at 0 launches, every other kernel
    once per decode frame the row ran ((1 warm + 3 x ``chunks``) x 20)."""
    frames = (1 + 3 * chunks) * 20
    if len(records) != 4:
        fail(f"tools: ab_kernel_gates gave {len(records)} rows")
    for rec in records:
        off = GATE_KERNELS.get(rec["label"])
        want = {name: 0 if name == off else frames for name in rec["launches"]}
        if rec["launches"] != want or rec["frames"] != frames:
            fail(f"tools: ab_kernel_gates {rec['label']!r}: launches {rec['launches']} over "
                 f"{rec['frames']} frames, want {want}")
        if not (math.isfinite(rec["ms_per_frame"]) and rec["ms_per_frame"] > 0):
            fail(f"tools: ab_kernel_gates {rec['label']!r}: {rec['ms_per_frame']} ms/frame")
    base = records[0]["ms_per_frame"]
    return ", ".join(f"{r['label']} {r['ms_per_frame']:.3f} ms/frame "
                     f"({r['ms_per_frame'] / base:.2f}x)" for r in records)


def check_report(rep: dict, label: str) -> str:
    """A benchmark report: three rows, each ``audio_s`` its frames x 2048 /
    44 100 (rounded as written), a first chunk and a three-stream batch."""
    rows = rep.get("rows", [])
    if len(rows) != 3:
        fail(f"tools: {label}: {len(rows)} rows")
    for r in rows:
        want = r["frames"] * 2048 / 44100
        if r["frames"] <= 0 or abs(r["audio_s"] - want) > 6e-4 or not r["wall_s"] > 0:
            fail(f"tools: {label} row {r['name']}: audio_s {r['audio_s']} for {r['frames']} "
                 f"frames (want {want:.4f}), wall_s {r['wall_s']}")
    st, b = rep.get("streaming", {}), rep.get("batch", {})
    if not (st.get("ttfa_s", 0) > 0 and st.get("chunks", 0) > 0):
        fail(f"tools: {label}: streaming {st}")
    if b.get("streams") != 3 or not b.get("audio_s", 0) > 0:
        fail(f"tools: {label}: batch {b}")
    return (f"mean RTF {rep['mean_rtf']}, rows " +
            ", ".join(f"{r['name']} {r['frames']} frames RTF {r['rtf']}" for r in rows) +
            f"; TTFA {st['ttfa_s']} s; batch of 3 RTF {b['rtf']}; peak "
            f"{rep['peak_memory_gb']} GB")


def check_bench(line: dict, argv) -> str:
    """The bench's JSON line at ``argv``: exactly the keys its stages give
    (no fallback or failure key), the card's ``nvidia-smi`` line as its
    device, every number finite and positive (a first-use cost finite and
    not negative), ``rtf`` x ``value`` = 44 100 / 2048 x ``batch`` within
    the rounding of the two (``rtf`` to 4 decimals, ``value`` to 1), the
    frames timed and the serving slots at the bench's settings, and the
    precision asked for."""
    from fish_tts_tpu_torch.scripts import bench

    label = f"bench {' '.join(argv)}".strip()
    want = set(BENCH_DECODE_KEYS)
    agg = int(argv[argv.index("--aggregate-batch") + 1]) if "--aggregate-batch" in argv else 8
    if agg > 1:
        want |= {f"aggregate_tok_per_sec_b{b}" for b in ({agg, 16} if agg == 8 else {agg})}
    if "--no-ttfa" not in argv:
        want |= BENCH_USER_KEYS
    if set(line) != want:
        fail(f"tools: {label}: missing keys {sorted(want - set(line))}, extra keys "
             f"{sorted(set(line) - want)}")
    if line["device"] != card_line():
        fail(f"tools: {label}: device {line['device']!r}, want {card_line()!r}")
    for key, v in line.items():
        if isinstance(v, str):
            continue
        values = v if isinstance(v, list) else [v]
        zero_ok = key in BENCH_MAY_BE_ZERO
        if not values or not all(type(x) in (int, float) and math.isfinite(x)
                                 and (x >= 0 if zero_ok else x > 0) for x in values):
            fail(f"tools: {label}: {key} = {v}")
    product, want_product = line["rtf"] * line["value"], bench.AUDIO_TOKENS_PER_SEC * line["batch"]
    if abs(product - want_product) > 5e-5 * line["value"] + 0.05 * line["rtf"] + 1e-9:
        fail(f"tools: {label}: rtf {line['rtf']} x value {line['value']} = {product}, want "
             f"{want_product}")
    frames = int(argv[argv.index("--frames") + 1]) if "--frames" in argv else 200
    if line["frames_timed"] != frames // bench.CHUNK * bench.CHUNK:
        fail(f"tools: {label}: frames_timed {line['frames_timed']}, want {frames}")
    if "serve_slots" in want and line["serve_slots"] != 16:
        fail(f"tools: {label}: serve_slots {line['serve_slots']}, want 16")
    precision = "bf16" if "--bf16" in argv else "int8"
    if line["precision"] != precision:
        fail(f"tools: {label}: precision {line['precision']}, want {precision}")
    return ", ".join(f"{k} {line[k]}" for k in sorted(line) if k not in ("metric", "unit"))


def check_rows(name: str, records) -> None:
    """Every measured row of a profiler finite and positive."""
    for rec in records:
        if rec.get("derived"):
            continue  # a remainder computed from the other rows
        values = [rec[k] for k in ("value", "host_s", "frames_per_s") if k in rec]
        if not values or not all(math.isfinite(v) and v > 0 for v in values):
            fail(f"tools: {name} row {rec.get('label')!r}: {values}")


def phase_tools() -> None:
    """Every measurement script once (TOOLS), each through its ``main(argv)``
    in this process, its lines printed, checked as the module docstring
    says, its weights freed before the next; the launches of the whole
    phase, read from counts set to 0 just before it, go to path "tools"."""
    import contextlib
    import gc
    import importlib

    import torch

    zero_counts()
    t_phase = time.perf_counter()
    for name, argv in TOOLS:
        mod = importlib.import_module(f"fish_tts_tpu_torch.scripts.{name}")
        t = time.perf_counter()
        before = kernel_counts()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            got = mod.main(list(argv))
        text = out.getvalue()
        print(text, end="", flush=True)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        note = ""
        if name == "verify_sampler":
            lines = [ln for ln in text.splitlines() if ln.startswith("B=")]
            if got != 0 or len(lines) != 18 or not all(": OK" in ln for ln in lines):
                fail(f"tools: verify_sampler returned {got} over {len(lines)} lines")
            note = text.strip().splitlines()[-1]
        elif name == "ab_kernel_gates":
            note = check_gates(got, int(argv[argv.index("--chunks") + 1]))
        elif name == "ab_kvbucket":
            rest = argv[argv.index("--buckets") + 1:]
            want = [int(b) for b in rest[:next((i for i, a in enumerate(rest)
                                                 if a.startswith("-")), len(rest))]]
            if [r["kv_bucket"] for r in got] != want:
                fail(f"tools: ab_kvbucket ran {[r['kv_bucket'] for r in got]}, want {want}")
            check_rows(name, [{"label": r["kv_bucket"], "value": r["ms_per_frame"]} for r in got])
            note = ", ".join(f"kv {r['kv_bucket']}: {r['ms_per_frame']:.3f} ms/frame" for r in got)
        elif name == "benchmark":
            rep = json.loads(text.strip().splitlines()[-1])
            note = check_report(rep, f"benchmark {argv[argv.index('--precision') + 1]}")
        elif name == "bench":
            if json.loads(text.strip().splitlines()[-1]) != got:
                fail(f"tools: bench {' '.join(argv)}: its last line is not the line it returned")
            added = {k: n - before[k] for k, n in kernel_counts().items()}
            note = f"{check_bench(got, argv)}; kernel launches {json.dumps(added)}"
            check_bench_launches(added, argv)
        else:
            check_rows(name, got)
            note = f"{len(got)} rows"
        print(f"tools: {name} {' '.join(argv)}: {note}; {time.perf_counter() - t:.1f} s",
              flush=True)
    launches = kernel_counts()
    if not all(launches[k] > 0 for k in ("sample_slow", "slow_stack_step", "fast_decode_frame")):
        fail(f"tools: kernel launches {launches}")
    tally("tools", launches)
    print(f"tools: {len(TOOLS)} runs in {time.perf_counter() - t_phase:.1f} s; kernel launches "
          f"{json.dumps(launches)}", flush=True)


def check_bench_launches(added: dict[str, int], argv) -> None:
    """The launches of one bench run at ``argv``: at int8 the three kernels of
    the tied-head route (``"value"`` fast decoder) each launch and no other;
    at bf16 only the sampler launches."""
    on = (("sample_slow",) if "--bf16" in argv
          else ("sample_slow", "slow_stack_step", "fast_decode_frame"))
    if not all(added[k] > 0 for k in on) or any(n for k, n in added.items() if k not in on):
        label = f"bench {' '.join(argv)}".strip()
        fail(f"tools: {label}: kernel launches {added}, want each of {on} and no other")


# --- phase 4: the decode graph against the eager loop ---------------------------


def device_and_host_us(fn, n: int) -> tuple[float, float]:
    """Per call, µs: the device's time for ``n`` calls of ``fn`` enqueued
    behind a sleeping kernel (so the host cannot hold the device back), and
    the host's time to enqueue them.  Their launches must fit in the
    device's queue, or the host waits for the sleep."""
    import torch

    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)  # ~0.1 s of device time
    a.record()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    host = (time.perf_counter() - t) / n * 1e6
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n * 1e3, host


def state_copy(state):
    return {k: ({kk: vv.clone() for kk, vv in v.items()} if k == "kv" else v.clone())
            for k, v in state.items()}


def state_diff(a, b) -> list[str]:
    """The names of the state's tensors that are not bit-equal."""
    import torch

    names = [f"kv.{k}" for k in a["kv"] if not torch.equal(a["kv"][k], b["kv"][k])]
    return names + [k for k in a if k != "kv" and not torch.equal(a[k], b[k])]


def graph_state(params, cfg, ids, B: int, done, gen, dev):
    """A mid-generation decode state at S1-mini width, drawn from ``gen``:
    cache rows, positions in [READ_LEN / 2, READ_LEN - GRAPH_FRAMES), last
    frames, penalty windows and steps; the streams in ``done`` have stopped."""
    import torch

    from fish_tts_tpu_torch.engine import decode

    state = decode.init_state(params, cfg, B, max_seq_len=CACHE_LEN, window=WINDOW)
    for t in state["kv"].values():
        t.copy_(torch.randn(t.shape, generator=gen, device=dev) * 0.5)
    i32 = dict(generator=gen, device=dev, dtype=torch.int32)
    state["pos"].copy_(torch.randint(READ_LEN // 2, READ_LEN - GRAPH_FRAMES, (B,), **i32))
    K1 = 1 + cfg.num_codebooks
    codes = torch.randint(0, cfg.residual_codebook_size, (B, K1, WINDOW + 1), **i32)
    codes[:, 0] = codes[:, 1] + ids.semantic_begin  # semantic tokens
    state["frame"].copy_(codes[:, :, 0])
    state["prev"].copy_(codes[:, :, 1:])
    state["step"].copy_(torch.randint(WINDOW // 2, 4 * WINDOW, (B,), **i32))
    state["done"][list(done)] = True
    return state


def graph_nodes(graph, reps: int = 4) -> float | None:
    """Device operations (kernels, copies, fills) per frame of a
    ``decode.DecodeGraph``, counted by ``torch.profiler`` over ``reps``
    replays of its CUDA graph (the ring's counter reset first, as
    ``DecodeGraph.run`` does): the graph's nodes.  None when the trace
    holds none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    graph.ring.t.zero_()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            graph.graph.replay()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events() if str(e.device_type).endswith("CUDA"))
    return n / reps if n else None


def graph_against_eager(params, cfg, ids, rope, case, gen, dev, **options) -> dict:
    """One case of GRAPH_CASES: GRAPH_FRAMES frames through the eager loop
    (``decode.decode_chunk``) and through the captured graph
    (``decode.DecodeGraph``) from equal copies of one state with the same
    noise seed, on the route ``options`` give: frames, emitted flags and the
    whole state, KV cache included, bit-equal.  Then the device and host time
    of a live and of a skipped frame (every stream done) of the graph, and
    its node count."""
    import torch

    from fish_tts_tpu_torch.engine import decode

    label, B, done = case
    noise = decode.GumbelNoise(SEED, cfg)
    state = graph_state(params, cfg, ids, B, done, gen, dev)
    decode.set_sampling(state, *SAMPLING)
    decode.set_noise(state, noise)
    eager, graphed = state_copy(state), state_copy(state)

    _, f_e, e_e = decode.decode_chunk(params, rope, eager, noise, *SAMPLING, cfg=cfg, ids=ids,
                                      num_frames=GRAPH_FRAMES, kv_bucket=READ_LEN,
                                      early_exit=True, **options)
    graph = decode.DecodeGraph(params, cfg, ids, rope, graphed, kv_bucket=READ_LEN,
                               skip_done=True, capacity=GRAPH_FRAMES, **options)
    f_g, e_g = graph.run(GRAPH_FRAMES)
    torch.cuda.synchronize()
    diff = state_diff(eager, graphed)
    if not (torch.equal(f_e, f_g) and torch.equal(e_e, e_g)) or diff:
        fail(f"decode graph {label}: differs from the eager loop "
             f"(frames {torch.equal(f_e, f_g)}, emitted {torch.equal(e_e, e_g)}, "
             f"state {diff})")
    live = [b for b in range(B) if b not in done]
    tokens = set(f_g[live, :, 0].flatten().tolist())
    if not e_g[live].all() or e_g[list(done)].any() or len(tokens) < 8:
        fail(f"decode graph {label}: emitted {e_g.tolist()}, {len(tokens)} distinct tokens")
    n = GRAPH_FRAMES
    live_us, live_host = (t / n for t in device_and_host_us(lambda: graph.run(n), 1))
    graphed["done"].fill_(True)
    skip_us, skip_host = (t / n for t in device_and_host_us(lambda: graph.run(n), 1))
    nodes = graph_nodes(graph)
    print(f"graph {label}: {GRAPH_FRAMES} frames bit-equal to the eager loop (frames, "
          f"emitted, state, KV cache; streams {list(done)} done from the start); "
          f"device {live_us:.1f} us per live frame, {skip_us:.1f} us per skipped frame; "
          f"host {live_host:.1f} us per live replay, {skip_host:.1f} us per skipped replay; "
          f"{'not measured' if nodes is None else f'{nodes:.0f}'} device operations per "
          f"replay (profiler)", flush=True)
    return {"live_us": live_us, "skip_us": skip_us, "nodes": nodes}


def phase_graph(dev) -> None:
    """The int8 kernel route at S1-mini width: GRAPH_CASES through
    :func:`graph_against_eager`; then the tiny config's forced EOS."""
    import torch

    from fish_tts_tpu_torch.models.dual_ar import TokenIds, make_rope_tables
    from fish_tts_tpu_torch.testing import make_s1_mini_bundle
    from fish_tts_tpu_torch.utils.quantize import quantize_lm_params

    cfg, params, tok, *_ = make_s1_mini_bundle(SEED, device=dev, with_vocoder=False)
    params = quantize_lm_params(params)
    rope = make_rope_tables(cfg, device=dev)
    ids = TokenIds(tok.semantic_begin_id, tok.semantic_end_id, tok.im_end_id)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 11)
    for case in GRAPH_CASES:
        graph_against_eager(params, cfg, ids, rope, case, gen, dev)
    del params
    torch.cuda.empty_cache()
    check_tiny_eos(dev)


def check_tiny_eos(dev, n: int = 24) -> None:
    """The tiny config with a forced EOS, as ``tests/test_torch_decode.py``
    forces it (``ids.im_end`` set to a slow token the stream samples
    mid-chunk): the decode graph on the card against the eager loop on the
    CPU, from the same prompt and noise.  Frames, emitted flags and the
    integer state equal; the KV cache within REL_TOL of its largest
    magnitude; every frame after the stop skipped."""
    import numpy as np
    import torch

    from fish_tts_tpu_torch.engine import decode
    from fish_tts_tpu_torch.models.dual_ar import TokenIds, make_rope_tables
    from fish_tts_tpu_torch.models.prompt import build_prompt
    from fish_tts_tpu_torch.testing import make_tiny_bundle
    from fish_tts_tpu_torch.utils.checkpoint import to_device
    from fish_tts_tpu_torch.utils.quantize import quantize_lm_params

    cfg, params, tok, *_ = make_tiny_bundle(SEED)
    params = quantize_lm_params(params)
    ids = TokenIds(tok.semantic_begin_id, tok.semantic_end_id, tok.im_end_id)
    enc = build_prompt(tok, "Hi there.", cfg.num_codebooks).values
    prompt = np.zeros((1, enc.shape[0], 64), np.int32)
    prompt[0, :, :enc.shape[1]] = enc
    noise = decode.GumbelNoise(SEED, cfg)

    def run(device, ids):
        p = to_device(params, device)
        rope = make_rope_tables(cfg, device=device)
        state = decode.init_state(p, cfg, 1, max_seq_len=cfg.max_seq_len)
        _, first = decode.prefill(p, rope, state, torch.as_tensor(prompt, device=device),
                                  torch.tensor([enc.shape[1]], device=device), noise,
                                  *SAMPLING, cfg=cfg, ids=ids, kv_bucket=0)
        if device == "cpu":
            _, f, e = decode.decode_chunk(p, rope, state, noise, *SAMPLING, cfg=cfg, ids=ids,
                                          num_frames=n, kv_bucket=cfg.max_seq_len,
                                          early_exit=True)
        else:
            f, e = decode.DecodeGraph(p, cfg, ids, rope, state, kv_bucket=cfg.max_seq_len,
                                      skip_done=True, capacity=n).run(n)
        return int(first[0, 0]), f.cpu(), e.cpu(), state

    first, frames, _, _ = run("cpu", ids)
    tokens = frames[0, :, 0].tolist()
    stop = next(k for k in range(4, n - 8)
                if tokens.index(tokens[k]) == k and tokens[k] != first)
    forced = dataclasses.replace(ids, im_end=tokens[stop])
    _, f_c, e_c, s_c = run("cpu", forced)
    _, f_g, e_g, s_g = run(dev, forced)
    s_g = {k: ({kk: vv.cpu() for kk, vv in v.items()} if k == "kv" else v.cpu())
           for k, v in s_g.items()}
    ints = [k for k in ("frame", "pos", "prev", "step", "done") if not torch.equal(s_c[k], s_g[k])]
    if not (torch.equal(f_c, f_g) and torch.equal(e_c, e_g)) or ints:
        fail(f"tiny forced EOS: the graph on the card differs from the CPU's eager loop "
             f"(frames {torch.equal(f_c, f_g)}, emitted {torch.equal(e_c, e_g)}, state {ints})")
    if e_g[0, stop + 1:].any() or not e_g[0, :stop + 1].all():
        fail(f"tiny forced EOS at frame {stop}: emitted {e_g[0].tolist()}")
    kv_rel = max(rel_err(s_g["kv"][k], s_c["kv"][k])[1] for k in ("k", "v"))
    if not kv_rel <= REL_TOL:
        fail(f"tiny forced EOS: KV cache relative error {kv_rel:.3g} > {REL_TOL}")
    print(f"graph tiny: forced EOS at frame {stop}; {n} frames of the graph on the card equal "
          f"to the CPU's eager loop (frames, emitted, integer state), {n - stop - 1} frames "
          f"skipped; KV cache rel err {kv_rel:.2e}", flush=True)


# --- phase 5: the main path --------------------------------------------------------


def check_tiny_engine(dev, frames: int = 40) -> None:
    """The engine on the card against the same engine on the CPU (plain
    versions, held against the JAX package by the CPU tests) at the tiny
    config with int8 f32 weights and the same noise: equal codes, for one
    stream and for a batch of TINY_TEXTS in two prompt buckets with
    per-stream sampling parameters."""
    import numpy as np

    from fish_tts_tpu_torch.config import EngineConfig
    from fish_tts_tpu_torch.engine.decode import GumbelNoise
    from fish_tts_tpu_torch.engine.generate import GenerationEngine
    from fish_tts_tpu_torch.models.prompt import build_prompt
    from fish_tts_tpu_torch.testing import make_tiny_bundle
    from fish_tts_tpu_torch.utils.checkpoint import to_device
    from fish_tts_tpu_torch.utils.quantize import quantize_lm_params

    cfg, params, tok, *_ = make_tiny_bundle(SEED)
    params = quantize_lm_params(params)
    codes = []
    for device in ("cpu", dev):
        engine = GenerationEngine(to_device(params, device), cfg, tok)
        out = engine.generate_long("Hi there.", max_new_tokens=frames,
                                   temperature=SAMPLING[0], top_p=SAMPLING[1],
                                   repetition_penalty=SAMPLING[2],
                                   noise=GumbelNoise(SEED, cfg, "cpu"))
        codes.append(next(out).codes)
    if codes[0].shape != codes[1].shape or not np.array_equal(*codes):
        fail(f"tiny engine: codes on the card differ from the CPU path's "
             f"({codes[1].shape} vs {codes[0].shape})")
    print(f"main: tiny config, {codes[0].shape[1] + 1} frames on the card equal to the "
          f"CPU path's", flush=True)
    batches = []
    for device in ("cpu", dev):
        engine = GenerationEngine(to_device(params, device), cfg, tok,
                                  EngineConfig(prompt_buckets=TINY_BUCKETS))
        batches.append(engine.generate_batch(list(TINY_TEXTS), max_new_tokens=frames,
                                             **batch_sampling(len(TINY_TEXTS))))
    groups = len(engine._bucket_groups(np.array([
        build_prompt(tok, t, cfg.num_codebooks).values.shape[1] for t in TINY_TEXTS])))
    if groups != 2 or not all(a.shape == b.shape and np.array_equal(a, b)
                              for a, b in zip(*batches)):
        fail(f"tiny engine batch: {groups} prompt groups; codes on the card differ from the CPU "
             f"path's ({[c.shape for c in batches[1]]} vs {[c.shape for c in batches[0]]})")
    print(f"main: tiny config, a batch of {len(TINY_TEXTS)} streams in {groups} prompt buckets "
          f"with per-stream sampling: {[c.shape[1] + 1 for c in batches[0]]} frames on the card "
          f"equal to the CPU path's", flush=True)


def observe(tts) -> dict:
    """Wrap the instance's generation and codec so that each call records
    its codes, float audio and generation time in the returned dict."""
    import torch

    seen = {}
    gen_long, decode_codes = tts.engine.generate_long, tts._decode_codes

    def generate_long(*a, **k):
        t = time.perf_counter()
        for resp in gen_long(*a, **k):
            if resp.action == "sample":
                torch.cuda.synchronize()
                seen["gen_s"] = time.perf_counter() - t
                seen["codes"] = resp.codes
            yield resp

    def decode(codes):
        seen["audio"] = audio = decode_codes(codes)
        return audio

    tts.engine.generate_long, tts._decode_codes = generate_long, decode
    return seen


def reference_profile(cfg):
    """A cloned voice's reference: REF_FRAMES frames of seeded random codes
    (row 0 semantic, the others residual) and a transcript."""
    import numpy as np

    from fish_tts_tpu_torch import VoiceProfile

    rng = np.random.default_rng(SEED)
    codes = rng.integers(0, cfg.residual_codebook_size, (cfg.num_codebooks, REF_FRAMES))
    codes[0] = rng.integers(0, cfg.codebook_size, REF_FRAMES)
    return VoiceProfile(codes=codes, text="A reference transcript read by the voice to clone.")


def phase_main(dev, profile_dir=None):
    import torch

    from fish_tts_tpu_torch import FishTTS
    from fish_tts_tpu_torch.testing import make_s1_mini_bundle

    check_tiny_engine(dev)
    bundle = make_s1_mini_bundle(SEED, device=dev)
    t0 = time.perf_counter()
    tts = FishTTS(device="cuda", precision="int8", warmup=True, seed=SEED,
                  _testing_bundle=bundle)
    torch.cuda.synchronize()
    print(f"main: FishTTS(int8) at S1-mini width built and warmed up in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    seen = observe(tts)
    launches = synthesize_once(tts, seen, "synthesize")
    first_wav = seen["wav"]
    phase_convert(tts, bundle, seen)
    synthesize_once(tts, seen, f"synthesize with a {REF_FRAMES}-frame reference",
                    references=[reference_profile(tts._cfg)])
    compare_routes(tts, seen)
    if profile_dir is not None:
        profile_synthesize(tts, Path(profile_dir), seen["frames"])
        sampler_on_path(tts)
    phase_stream(tts, seen, "int8")
    phase_batch(tts, "int8")
    phase_serve(tts, "int8")
    profile = phase_encode(tts, seen, first_wav)
    phase_http(tts, first_wav, profile)
    phase_long(tts)
    phase_mesh(tts, bundle)
    return launches


# --- phase 5b: the reference's checkpoint files ------------------------------------


def convert_instance(d: Path, label: str, want_codes, want_wav: bytes) -> float:
    """``FishTTS(model_dir=d, precision="int8")`` built, warmed up as phase 5's
    instance is and called as its first ``synthesize`` is, with the same
    seed: its codes and WAV must equal that call's, bit for bit.  The call
    counts to path "convert"; the instance is freed.  Returns the seconds
    the load took (construction without the warmup)."""
    import gc

    import numpy as np
    import torch

    from fish_tts_tpu_torch import FishTTS

    torch.cuda.synchronize()
    t = time.perf_counter()
    tts = FishTTS(model_dir=d, device="cuda", precision="int8", warmup=False, seed=SEED)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    tts._run_warmup()  # what warmup=True runs: one generation, the noise's first draw
    seen = observe(tts)
    synthesize_once(tts, seen, f"convert: {label}", path="convert")
    if seen["codes"].shape != want_codes.shape or not np.array_equal(seen["codes"], want_codes):
        fail(f"convert: {label}: codes {seen['codes'].shape} differ from the in-memory "
             f"instance's first call {want_codes.shape}")
    if seen["wav"] != want_wav:
        fail(f"convert: {label}: the WAV differs from the in-memory instance's first call")
    print(f"convert: {label}: loaded in {load_s:.2f} s; codes ({seen['codes'].shape[1]} "
          f"frames) and WAV ({len(want_wav)} bytes) equal to the in-memory instance's first "
          f"call", flush=True)
    del tts, seen
    gc.collect()
    torch.cuda.empty_cache()
    return load_s


def phase_convert(tts, bundle, seen) -> None:
    """Phase 5's S1-mini bundle written in the reference's checkpoint layout
    (``testing.write_reference_dir``: ``model.pth`` bf16, ``codec.pth`` f32
    with every conv's weight norm split into
    ``parametrizations.weight.original0/1``, keys under ``generator.``) into
    a temporary directory with config.json, tokenizer.tiktoken and
    special_tokens.json, removed at the end.  Then: ``FishTTS`` on that
    directory and on the directory ``python -m
    fish_tts_tpu_torch.scripts.convert_checkpoint --verify`` converts it
    into, each with the codes and WAV of phase 5's first call
    (``convert_instance``); ``init_model`` on the converted directory and
    the module-level ``generate_long``, whose codes must equal phase 5's
    engine's ``generate_long`` with the same arguments and seed.  Prints
    the load times (.pth against safetensors), the file sizes, the coverage
    reports and the launches (path "convert")."""
    import gc
    import shutil
    import tempfile

    import numpy as np
    import torch

    from fish_tts_tpu_torch import testing
    from fish_tts_tpu_torch.models import generate_long, init_model

    t0 = time.perf_counter()
    want_codes, want_wav = seen["codes"].copy(), seen["wav"]
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_convert_"))
    try:
        t = time.perf_counter()
        ref = testing.write_reference_dir(root / "reference", bundle)
        write_s = time.perf_counter() - t
        files = sorted(f.name for f in ref.iterdir())
        if files != ["codec.pth", "config.json", "model.pth", "special_tokens.json",
                     "tokenizer.tiktoken"]:
            fail(f"convert: the reference directory holds {files}")
        sizes = {f: (ref / f).stat().st_size for f in ("model.pth", "codec.pth")}
        print(f"convert: model.pth ({sizes['model.pth'] / 1e9:.3f} GB, bf16) and codec.pth "
              f"({sizes['codec.pth'] / 1e9:.3f} GB, f32, weight norm) written in "
              f"{write_s:.1f} s", flush=True)
        pth_s = convert_instance(ref, "model.pth + codec.pth", want_codes, want_wav)

        out = root / "native"
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "fish_tts_tpu_torch.scripts.convert_checkpoint", str(ref),
             str(out), "--verify"], cwd=ROOT, capture_output=True, text=True, timeout=600)
        convert_s = time.perf_counter() - t
        for line in proc.stdout.splitlines():
            print(f"convert: {line}", flush=True)
        if proc.returncode != 0:
            fail(f"convert: convert_checkpoint --verify exited {proc.returncode}: "
                 f"{proc.stderr[-2000:]}")
        shutil.rmtree(ref)
        sizes.update({f: (out / f).stat().st_size
                      for f in ("lm.safetensors", "vocoder.safetensors")})
        print(f"convert: convert_checkpoint --verify took {convert_s:.1f} s (its own process); "
              f"lm.safetensors {sizes['lm.safetensors'] / 1e9:.3f} GB (bf16), "
              f"vocoder.safetensors {sizes['vocoder.safetensors'] / 1e9:.3f} GB (f32)",
              flush=True)
        native_s = convert_instance(out, "converted safetensors", want_codes, want_wav)

        kw = dict(max_new_tokens=MAX_TOKENS, temperature=SAMPLING[0], top_p=SAMPLING[1],
                  repetition_penalty=SAMPLING[2])
        # phase 5's engine with the noise the first generation after reseed(0)
        # draws, its own sequence left as it is; a fresh engine draws that first
        want = [r.codes for r in tts.engine.generate_long(
            TEXT, noise=tts.engine._seed_noise(0), **kw) if r.action == "sample"]
        torch.cuda.synchronize()
        t = time.perf_counter()
        engine, _ = init_model(out, device="cuda", precision="int8")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t
        zero_counts()
        got = [r.codes for r in generate_long(model=engine, text=TEXT, **kw)
               if r.action == "sample"]
        torch.cuda.synchronize()
        if len(got) != 1 or len(want) != 1 or got[0].shape != want[0].shape or (
                not np.array_equal(got[0], want[0])):
            fail(f"convert: init_model + generate_long codes {[c.shape for c in got]} differ "
                 f"from phase 5's engine's {[c.shape for c in want]}")
        frames = got[0].shape[1] + 1  # generate_long strips the final frame
        launches, replays, _ = route_counts(engine, "convert: init_model + generate_long",
                                            frames - 2, "convert")
        print(f"convert: init_model loaded in {init_s:.2f} s; generate_long: {frames} frames, "
              f"codes equal to phase 5's engine's with the same seed; kernel launches "
              f"{json.dumps(launches)}, {replays} graph replays", flush=True)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"convert: loads .pth {pth_s:.2f} s, safetensors {native_s:.2f} s, init_model "
          f"{init_s:.2f} s; launches {json.dumps(PATH_LAUNCHES['convert'])}; phase took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def eager_route(engine):
    """A stand-in for ``engine._decode`` that runs the eager loop on the
    card, for measuring the graph route against it."""
    from fish_tts_tpu_torch.engine import decode

    def run(state, noise, sampling, n, kv_bucket, early_exit):
        _, frames, emitted = decode.decode_chunk(
            engine.params, engine.rope, state, noise, *sampling, cfg=engine.cfg, ids=engine.ids,
            num_frames=n, kv_bucket=kv_bucket, early_exit=early_exit, **engine._options)
        return frames, emitted

    return run


def decode_busy(prof, first: str, last: str) -> tuple[float, float] | None:
    """The device's busy share of the decode span of a profiled call, and
    the span (ms): from the first ``first`` kernel's start to the last
    ``last`` kernel's end (the slow stack and the fast decoder on the int8
    route, the sampler on a float one), the union of every device activity
    over that span.  None when the trace holds no such kernels."""
    evs = [e for e in prof.events() if str(e.device_type).endswith("CUDA")]
    slow = [e.time_range for e in evs if first in e.name]
    fast = [e.time_range for e in evs if last in e.name]
    if not slow or not fast:
        return None
    t0, t1 = min(r.start for r in slow), max(r.end for r in fast)
    busy, end = 0.0, t0
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in evs):
        a, b = max(a, end), min(b, t1)
        if b > a:
            busy += b - a
            end = b
    return busy / (t1 - t0), (t1 - t0) / 1e3


def compare_routes(tts, seen, markers=("slow_step_kernel", "fast_frame_kernel"),
                   runs_each: int = ROUTE_RUNS, profile_tokens: int = MAX_TOKENS,
                   label: str = "") -> None:
    """The same call on both decode routes: ``runs_each`` synthesize calls
    on each in turns (graph, eager, eager, graph, ...), then one profiled
    call of each with ``profile_tokens`` frames.  Prints frames/s and RTF of
    every call, the host's time per decode frame (its dispatch of the
    frames, which enqueues and does not wait) and the device's busy share of
    the decode span (``markers``: see :func:`decode_busy`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    engine = tts.engine
    host: dict[str, list[float]] = {}

    def timed(route, fn):
        def run(state, noise, sampling, n, *a, **k):
            t = time.perf_counter()
            out = fn(state, noise, sampling, n, *a, **k)
            h = host.setdefault(route, [0.0, 0])
            h[0] += time.perf_counter() - t
            h[1] += n
            return out
        return run

    routes = {"graph": timed("graph", engine._decode), "eager": timed("eager", eager_route(engine))}

    def call(route, max_tokens=MAX_TOKENS):
        with mock.patch.object(engine, "_decode", routes[route]):
            t = time.perf_counter()
            tts.synthesize(TEXT, temperature=SAMPLING[0], top_p=SAMPLING[1],
                           repetition_penalty=SAMPLING[2], max_tokens=max_tokens)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        frames = seen["codes"].shape[1] + 1
        return frames / seen["gen_s"], wall / (len(seen["audio"]) / tts.sample_rate)

    runs: dict[str, list[tuple[float, float]]] = {"graph": [], "eager": []}
    for i in range(runs_each):
        for route in (("graph", "eager") if i % 2 == 0 else ("eager", "graph")):
            runs[route].append(call(route))
    host_us = {r: h[0] / h[1] * 1e6 for r, h in host.items()}
    for route in ("graph", "eager"):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            call(route, profile_tokens)
        busy = decode_busy(prof, *markers)
        share = ("not measured (no decode kernels in the trace)" if busy is None else
                 f"{100 * busy[0]:.1f}% of a {busy[1]:.1f} ms decode span (profiled call "
                 f"of {profile_tokens} frames)")
        print(f"{label}route {route}: frames/s {[round(r, 1) for r, _ in runs[route]]}, RTF "
              f"{[round(x, 4) for _, x in runs[route]]} over {runs_each} calls; host "
              f"{host_us[route]:.1f} us per decode frame; device busy {share}", flush=True)


def sampler_on_path(tts) -> None:
    """One more synthesize with the sampler's round counter read after every
    call: its cluster rounds and live rows on the main path's own logits
    (on the eager route: a graph replay does not pass through the wrapper)."""
    import collections

    import torch

    from fish_tts_tpu_torch.ops import sampler_kernel as sk

    kernel_call, seen = sk.sample_slow, []

    def counted(logits, *rest):
        counter = torch.zeros((logits.shape[0], 3), dtype=torch.int32, device=logits.device)
        sk.round_counter = counter
        try:
            out = kernel_call(logits, *rest)
        finally:
            sk.round_counter = None
        seen.extend(counter.tolist())
        return out

    with mock.patch.object(sk, "sample_slow", counted), \
            mock.patch.object(tts.engine, "_decode", eager_route(tts.engine)):
        tts.synthesize(TEXT, temperature=SAMPLING[0], top_p=SAMPLING[1],
                       repetition_penalty=SAMPLING[2], max_tokens=MAX_TOKENS)
    rounds = collections.Counter(r for r, _, _ in seen)
    live = sorted(n for _, n, _ in seen if n >= 0)
    block = collections.Counter(k for _, n, k in seen if n >= 0)
    print(f"sampler on the main path: {len(seen)} rows; cluster rounds "
          f"{dict(sorted(rounds.items()))}; "
          f"live rows at compaction median {live[len(live) // 2] if live else None}, "
          f"max {live[-1] if live else None}; block-wide levels {dict(sorted(block.items()))}",
          flush=True)


def zero_counts() -> None:
    """Every kernel's launch count and both decode-route counters to 0."""
    from fish_tts_tpu_torch.engine import decode
    from fish_tts_tpu_torch.ops import fast_decoder, sampler_kernel, slow_stack

    for m in (sampler_kernel, slow_stack, fast_decoder):
        m.launches = 0
    slow_stack.headless_launches = 0
    fast_decoder.launches_s8 = 0
    decode.graph_replays = decode.eager_frames = 0


def kernel_counts() -> dict[str, int]:
    """Every kernel's launch count since :func:`zero_counts`."""
    from fish_tts_tpu_torch.ops import fast_decoder, sampler_kernel, slow_stack

    return {"sample_slow": sampler_kernel.launches, "slow_stack_step": slow_stack.launches,
            HEADLESS: slow_stack.headless_launches, "fast_decode_frame": fast_decoder.launches,
            S8: fast_decoder.launches_s8}


def stack_counts(cfg, frames: int) -> dict[str, int]:
    """The slow-stack launches of ``frames`` frames on its kernel: the tied
    head's variant or the head-less one."""
    tied = cfg.tie_word_embeddings
    return {"slow_stack_step": frames if tied else 0, HEADLESS: 0 if tied else frames}


def tally(path: str, launches: dict[str, int]) -> None:
    """Add a checked run's launches to its path's sums (PATH_LAUNCHES)."""
    sums = PATH_LAUNCHES.setdefault(path, dict.fromkeys(launches, 0))
    for name, n in launches.items():
        sums[name] += n


def route_counts(engine, label: str, min_replays: int, path: str, batch: int = 1,
                 prefills: int = 1):
    """The launch counts since :func:`zero_counts`, which must be what the
    call's route at ``batch`` streams implies (``decode.route``: a kernel on
    it launches once per frame for the whole batch, the sampler and the fast
    decoder also once per prefill, of which a batch makes one per prompt
    bucket, ``prefills``; the slow stack only in decode, its head-less
    variant for an untied head; a kernel off it not at all), with every
    decode frame, at least ``min_replays``, replayed from a captured graph.
    The counts go to ``path``'s sums.  Returns (launches, replays, the
    route)."""
    from fish_tts_tpu_torch.engine import decode

    launches = kernel_counts()
    replays, eager = decode.graph_replays, decode.eager_frames
    rt = decode.route(engine.cfg, engine.params, batch, engine.engine_cfg.rep_penalty_window,
                      **engine._options)
    decoded = replays + eager
    want = {"sample_slow": rt.sampler * (prefills + decoded),
            **stack_counts(engine.cfg, rt.slow_stack * decoded),
            "fast_decode_frame": rt.fast * (prefills + decoded), S8: 0}
    if launches != want or not any(want.values()):
        fail(f"{label}: kernel launches {launches}, the route implies {want}")
    if replays < min_replays or eager:
        fail(f"{label}: {replays} graph replays and {eager} eager decode frames")
    tally(path, launches)
    return launches, replays, rt


def synthesize_once(tts, seen, label: str, references=None, path: str = "main"
                    ) -> dict[str, int]:
    """One ``synthesize`` call with every kernel's launch count set to 0 just
    before it, counted to ``path``; checks the WAV and the launches and
    prints frames/s and RTF (also left in ``seen["fps"]``, the WAV in
    ``seen["wav"]``).  Returns the launch counts."""
    import numpy as np
    import torch

    zero_counts()
    tts.metrics.reset()
    t = time.perf_counter()
    wav = tts.synthesize(TEXT, references=references, temperature=SAMPLING[0],
                         top_p=SAMPLING[1], repetition_penalty=SAMPLING[2],
                         max_tokens=MAX_TOKENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    codes, audio = seen["codes"], seen["audio"]
    seen["frames"] = frames = codes.shape[1] + 1  # generate_long strips the final frame
    launches, replays, rt = route_counts(tts.engine, f"main: {label}", frames - 2, path)
    seen["wav"] = wav

    hop = tts._vocoder_cfg.frame_length
    with wave.open(io.BytesIO(wav)) as w:
        header = (w.getnchannels(), w.getsampwidth(), w.getframerate())
        n = w.getnframes()
    if wav[:4] != b"RIFF" or header != (1, 2, tts.sample_rate):
        fail(f"main: {label}: bad WAV header {wav[:4]!r} {header}")
    if codes.shape[0] != tts._cfg.num_codebooks or frames < 2:
        fail(f"main: {label}: codes of shape {codes.shape}")
    if n != (frames - 1) * hop or audio.shape != (n,):
        fail(f"main: {label}: {n} samples for {frames} frames, want {(frames - 1) * hop}")
    if not np.isfinite(audio).all():
        fail(f"main: {label}: audio is not finite")
    audio_s = n / tts.sample_rate
    seen["fps"] = frames / seen["gen_s"]
    print(f"main: {label} -> {len(wav)} WAV bytes, {frames} frames, {n} samples, "
          f"audio peak {float(np.abs(audio).max()):.4f}; {wall:.3f} s wall, "
          f"generation {seen['gen_s']:.3f} s = {seen['fps']:.1f} frames/s, "
          f"RTF {wall / audio_s:.4f}", flush=True)
    on = [n for n, k in (("slow stack", rt.slow_stack), ("sampler", rt.sampler),
                         ("fast decoder", rt.fast)) if k]
    print(f"main: {label}: kernel launches {json.dumps(launches)}, as the route implies "
          f"(kernels: {', '.join(on)}); {replays} decode frames replayed from captured "
          f"graphs, 0 eager", flush=True)
    print(f"main: {label}: get_metrics() {json.dumps(tts.get_metrics())}", flush=True)
    return launches


# --- phase 6: the float routes and the engine's options ----------------------------


def randomize_extras(params, gen) -> None:
    """Attention biases and qk-norm gains drawn from ``gen``, in place of the
    zeros and ones of ``init_params``."""
    import torch

    for stack in ("layers", "fast_layers"):
        for k, scale, base in (("wqkv_b", 0.1, 0.0), ("wo_b", 0.05, 0.0),
                               ("q_norm", 0.2, 1.0), ("k_norm", 0.2, 1.0)):
            t = params[stack].get(k)
            if t is not None:
                t.copy_(base + scale * torch.randn(t.shape, generator=gen, device=t.device))


def phase_float(dev, profile_dir=None) -> int:
    """``FishTTS(precision="bf16")``, the reference's default, at S1-mini
    width with random weights: a plain call and one with the 661-frame
    reference, each with the launch counts its route implies (the sampler
    kernel once per frame, the slow stack and the fast decoder not at all);
    the bf16 decode graph against the eager loop at B = 1 with its device
    time per frame and node count; both decode routes in turns.  Then one
    call each for fp16, fp32, int8 with an untied head (the head-less slow
    stack, then the int8 head), int8 with ``sample_top_k`` 0 and 8, and
    int8 with qk-norm and qkv and o biases in both stacks (the plain route
    for both stacks), each with its route's launch counts.  Returns the
    slow-stack launches of the untied-head call, the head-less kernel's."""
    import torch

    from fish_tts_tpu_torch import FishTTS
    from fish_tts_tpu_torch.config import EngineConfig
    from fish_tts_tpu_torch.models import dual_ar
    from fish_tts_tpu_torch.testing import make_s1_mini_bundle

    cfg, params, tok, vcfg, vparams = make_s1_mini_bundle(SEED, device=dev)

    def build(label, precision, c, p, engine_config=None):
        t0 = time.perf_counter()
        tts = FishTTS(device="cuda", precision=precision, warmup=True, seed=SEED,
                      engine_config=engine_config, _testing_bundle=(c, p, tok, vcfg, vparams))
        torch.cuda.synchronize()
        print(f"float: FishTTS({label}) at S1-mini width built and warmed up in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        return tts

    tts = build("bf16", "bf16", cfg, params)
    seen = observe(tts)
    synthesize_once(tts, seen, "bf16 synthesize")
    synthesize_once(tts, seen, f"bf16 synthesize with a {REF_FRAMES}-frame reference",
                    references=[reference_profile(cfg)])
    e = tts.engine
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 13)
    graph_against_eager(e.params, e.cfg, e.ids, e.rope, ("bf16 B=1", 1, ()), gen, dev,
                        **e._options)
    # a frame of the plain route is thousands of small kernels: two calls a
    # route, and a short profiled one
    compare_routes(tts, seen, markers=("sample_slow_kernel", "sample_slow_kernel"),
                   runs_each=2, profile_tokens=FLOAT_PROFILE_TOKENS, label="bf16 ")
    if profile_dir is not None:
        profile_synthesize(tts, Path(profile_dir), FLOAT_PROFILE_TOKENS + 1,
                           max_tokens=FLOAT_PROFILE_TOKENS, name="bf16_synthesize")
    phase_stream(tts, seen, "bf16")
    phase_batch(tts, "bf16")
    phase_serve(tts, "bf16")
    del tts, seen, e
    torch.cuda.empty_cache()

    gen.manual_seed(SEED + 17)
    untied = dataclasses.replace(cfg, tie_word_embeddings=False)
    untied_params = dict(params, output=(torch.randn((cfg.vocab_size, cfg.dim), generator=gen,
                                                     device=dev) * 0.02).to(torch.bfloat16))
    flags = dataclasses.replace(cfg, attention_qkv_bias=True, attention_o_bias=True,
                                attention_qk_norm=True, fast_attention_qkv_bias=True,
                                fast_attention_o_bias=True, fast_attention_qk_norm=True)
    calls = [("fp16", "fp16", cfg, lambda: params, None),
             ("fp32", "fp32", cfg, lambda: params, None),
             ("int8 untied head", "int8", untied, lambda: untied_params, None),
             ("int8 sample_top_k=0", "int8", cfg, lambda: params, EngineConfig(sample_top_k=0)),
             ("int8 sample_top_k=8", "int8", cfg, lambda: params, EngineConfig(sample_top_k=8)),
             ("int8 qk-norm, qkv and o biases", "int8", flags,
              lambda: dual_ar.init_params(gen, flags, torch.bfloat16), None)]
    headless = 0
    for label, precision, c, make, engine_config in calls:
        p = make()
        if c is flags:
            randomize_extras(p, gen)
        tts = build(label, precision, c, p, engine_config)
        launches = synthesize_once(tts, observe(tts), label)
        if c is untied:
            headless = launches[HEADLESS]
        del tts, p
        torch.cuda.empty_cache()
    return headless


def profile_synthesize(tts, out: Path, frames: int, max_tokens: int = MAX_TOKENS,
                       name: str = "synthesize") -> None:
    """One more synthesize under torch.profiler: device time by kernel and the
    device's busy share of the wall time; the whole table goes to
    ``out/{name}_kernels.txt``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out.mkdir(parents=True, exist_ok=True)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t = time.perf_counter()
        tts.synthesize(TEXT, temperature=SAMPLING[0], top_p=SAMPLING[1],
                       repetition_penalty=SAMPLING[2], max_tokens=max_tokens)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    rows = []
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue  # host ops: their device time is the kernels' below
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    (out / f"{name}_kernels.txt").write_text(
        "".join(f"{ms:10.3f} ms {n:7d} x {key}\n" for ms, n, key in rows))
    print(f"profile {name}: {wall_ms:.1f} ms wall for {frames} frames, device busy "
          f"{busy:.1f} ms ({100 * busy / wall_ms:.1f}%)", flush=True)
    for ms, n, key in rows[:12]:
        print(f"profile {name}: {ms:9.3f} ms {n:6d} x {key[:110]}", flush=True)


# --- phase 7: the stored reference and streaming ----------------------------------


def prefix_against_full_prompt(tts, profile, n: int) -> float:
    """The prefix state's KV rows [0, n) against the rows a prefill of the
    whole prompt (the same reference, then TEXT) writes, the plain prefill
    on both sides: the relative error to the largest magnitude."""
    import numpy as np
    import torch

    from fish_tts_tpu_torch.engine import decode
    from fish_tts_tpu_torch.models.prompt import build_prompt

    engine, dev = tts.engine, tts.device
    full = build_prompt(engine.tokenizer, TEXT, engine.cfg.num_codebooks,
                        prompt_texts=[profile.text], prompt_codes=[np.asarray(profile.codes)])
    padded, T = engine._pad_prompt(full.values)
    state = decode.init_state(engine.params, engine.cfg, 1, window=WINDOW)
    decode.prefill(engine.params, engine.rope, state, torch.as_tensor(padded, device=dev),
                   torch.tensor([T], dtype=torch.int32, device=dev),
                   decode.GumbelNoise(SEED, engine.cfg), *SAMPLING, cfg=engine.cfg,
                   ids=engine.ids, kv_bucket=0, **engine._options)
    prefix = engine._prefix_state["kv"]
    err = max(rel_err(prefix[k][:, :, :, :n], state["kv"][k][:, :, :, :n])[1] for k in ("k", "v"))
    del state
    torch.cuda.empty_cache()
    return err


def stream_call(tts, references, mode: str) -> dict:
    """One ``synthesize_stream(TEXT, max_tokens=MAX_TOKENS)`` with the engine
    reseeded to SEED: its PCM chunks, the codes the engine streamed, the
    wall time to the first chunk and to the last."""
    import numpy as np

    from fish_tts_tpu_torch.engine.generate import GenerationEngine

    engine, codes, at = tts.engine, [], []
    gen_long = GenerationEngine.generate_long.__get__(engine)  # without observe()'s wrapper

    def recording(*a, **k):
        for r in gen_long(*a, **k):
            if r.action == "sample":
                codes.append(r.codes)
                at.append(time.perf_counter())
            yield r

    engine.reseed(SEED)
    with mock.patch.object(engine, "generate_long", recording):
        t = time.perf_counter()
        chunks = tts.synthesize_stream(TEXT, references=references, temperature=SAMPLING[0],
                                       top_p=SAMPLING[1], repetition_penalty=SAMPLING[2],
                                       max_tokens=MAX_TOKENS, vocoder_mode=mode)
        first = next(chunks)
        ttfa = time.perf_counter() - t
        chunks = [first, *chunks]
        wall = time.perf_counter() - t
    return {"chunks": chunks, "codes": np.concatenate(codes, axis=1), "ttfa": ttfa,
            "first_codes": at[0] - t, "wall": wall,
            "pcm": np.frombuffer(b"".join(chunks), np.int16).astype(np.int32)}


def nonstreamed_codes(tts, references):
    """The codes of the same call, not streamed, with the engine reseeded to
    SEED (the final frame stripped)."""
    from fish_tts_tpu_torch.engine.generate import GenerationEngine

    prompt_text, prompt_tokens, use_prefix = tts._get_prompt_data(references)
    tts.engine.reseed(SEED)
    out = GenerationEngine.generate_long(
        tts.engine, TEXT, max_new_tokens=MAX_TOKENS, temperature=SAMPLING[0],
        top_p=SAMPLING[1], repetition_penalty=SAMPLING[2], prompt_text=prompt_text,
        prompt_tokens=prompt_tokens, use_prefix_cache=use_prefix)
    return next(out).codes


def check_stream(tts, label: str, references, mode: str) -> dict:
    """One checked ``synthesize_stream`` call (counts set to 0 just before
    it), then STREAM_RUNS timed ones.  Checks chunks of whole frames of
    int16 PCM, 10 frames then 20 then the rest, and the launches of the
    route with every decode frame replayed from a graph.  Prints the time to
    first audio (median), when the LM's first chunk reached the host, and
    the whole stream's frames/s.  Returns the checked call's record."""
    hop = tts._vocoder_cfg.frame_length
    zero_counts()
    r = stream_call(tts, references, mode)
    n = r["codes"].shape[1]
    launches, replays, _ = route_counts(tts.engine, f"stream: {label}", n - 1, "stream")
    if any(len(c) % (2 * hop) for c in r["chunks"]):
        fail(f"stream: {label}: a chunk of {[len(c) for c in r['chunks']]} bytes is not whole "
             f"frames")
    sizes = [len(c) // (2 * hop) for c in r["chunks"]]
    want = [10] + [20] * ((n - 10) // 20) + ([(n - 10) % 20] if (n - 10) % 20 else [])
    if sizes != want:
        fail(f"stream: {label}: chunks of {sizes} frames for {n} frames, want {want}")
    runs = [stream_call(tts, references, mode) for _ in range(STREAM_RUNS)]
    ttfa = [x["ttfa"] * 1e3 for x in runs]
    print(f"stream: {label}: {n} frames in chunks of {sizes} frames, {len(r['pcm'])} samples; "
          f"kernel launches {json.dumps(launches)}, {replays} decode frames replayed from "
          f"captured graphs, 0 eager", flush=True)
    print(f"stream: {label}: time to first audio {statistics.median(ttfa):.1f} ms (median of "
          f"{STREAM_RUNS} calls after the checked one: {[round(x, 1) for x in ttfa]}; the LM's "
          f"first 10 frames on the host at {[round(x['first_codes'] * 1e3, 1) for x in runs]} "
          f"ms); whole stream {[round(x['codes'].shape[1] / x['wall'], 1) for x in runs]} "
          f"frames/s", flush=True)
    return r


def phase_stream(tts, seen, name: str) -> None:
    """The stored reference and streaming on ``tts`` (``name`` its
    precision): ``set_references`` with the 661-frame profile (the prefix's
    length, the time it took, its KV rows against a full-prompt prefill);
    ``synthesize(references=None)`` through the prefix (the prefill starts
    at the prefix's offset with the text alone) against the same call with
    ``references=[profile]``, each warmed once; then ``synthesize_stream``
    through the prefix and with the explicit reference, each in both codec
    modes (:func:`check_stream`), the streamed codes equal to the
    non-streamed call's with the same seed, the stateful stream's PCM held
    against the joint decode; the codec's device time per 20-frame chunk.
    Every frame of the phase is B = 1, so none takes the fast decoder's
    spread attention (``fast_decoder.launches_spread`` unchanged).  Clears
    the references at the end."""
    import numpy as np
    import torch

    from fish_tts_tpu_torch.engine import decode
    from fish_tts_tpu_torch.models import vocoder, vocoder_stream
    from fish_tts_tpu_torch.models.dual_ar import cast_params
    from fish_tts_tpu_torch.ops import fast_decoder
    from fish_tts_tpu_torch.synthesizer import _vocoder_bucket
    from fish_tts_tpu_torch.utils.audio import to_pcm_bytes

    spread = fast_decoder.launches_spread
    profile = reference_profile(tts._cfg)
    engine = tts.engine
    torch.cuda.synchronize()
    t = time.perf_counter()
    tts.set_references([profile])
    torch.cuda.synchronize()
    set_ms = (time.perf_counter() - t) * 1e3
    n_prefix = int(engine._prefix_state["pos"][0])
    kv_rel = prefix_against_full_prompt(tts, profile, n_prefix)
    if not kv_rel <= PREFIX_KV_TOL:
        fail(f"stream {name}: the prefix's KV rows differ from a full-prompt prefill's by "
             f"{kv_rel:.3g} > {PREFIX_KV_TOL}")
    print(f"stream {name}: set_references with a {REF_FRAMES}-frame profile: prefix of "
          f"{n_prefix} tokens prefilled in {set_ms:.1f} ms; its KV rows against a full-prompt "
          f"prefill's: rel err {kv_rel:.2e} (tol {PREFIX_KV_TOL})", flush=True)

    # synthesize through the prefix, and with the explicit reference
    suffix = engine._encode_suffix(TEXT).values.shape[1]
    prefills = []
    real_prefill = decode.prefill

    def spy(params, rope, state, prompt, lengths, *a, **k):
        prefills.append((int(lengths[0]), int(state["pos"][0])))
        return real_prefill(params, rope, state, prompt, lengths, *a, **k)

    fps = {}
    for label, refs in (("the stored reference (prefix)", None),
                        ("references=[profile]", [profile])):
        tts.synthesize(TEXT, references=refs, max_tokens=MAX_TOKENS)  # warm: graph captures
        with mock.patch.object(decode, "prefill", spy):
            synthesize_once(tts, seen, f"{name} synthesize with {label}", references=refs)
        fps[label] = seen["fps"]
    (len_p, off_p), (len_e, off_e) = prefills
    if (len_p, off_p) != (suffix, n_prefix) or off_e != 0 or len_e <= n_prefix:
        fail(f"stream {name}: prefills (length, offset) {prefills}: want ({suffix}, "
             f"{n_prefix}) through the prefix and a full prompt from 0 with the reference")
    print(f"stream {name}: synthesize(references=None) prefilled {len_p} tokens at offset "
          f"{off_p} (the prefix), the explicit reference {len_e} from 0; frames/s "
          f"{fps['the stored reference (prefix)']:.1f} with the prefix, "
          f"{fps['references=[profile]']:.1f} with the explicit reference", flush=True)

    vp, vcfg = tts._vocoder_params, tts._vocoder_cfg
    vp32 = cast_params(vp, torch.float32)

    def pcm(audio) -> np.ndarray:
        return np.frombuffer(to_pcm_bytes(audio), np.int16).astype(np.int32)

    for label, refs in (("prefix", None), ("explicit reference", [profile])):
        batch = nonstreamed_codes(tts, refs)
        r = stream_call(tts, refs, "stateful")  # warm: the streaming graphs' captures
        codes = r["codes"]
        if codes.shape[1] != batch.shape[1] + 1:
            fail(f"stream {name} {label}: {codes.shape[1]} frames streamed, "
                 f"{batch.shape[1]} + 1 not streamed")
        differ = int((codes[:, :-1] != batch).sum())
        if differ:
            fail(f"stream {name} {label}: {differ} codes differ from the non-streamed call's")
        s = check_stream(tts, f"{name} {label} stateful", refs, "stateful")
        c = check_stream(tts, f"{name} {label} context", refs, "context")
        for got in (s, c):
            if not np.array_equal(got["codes"], codes):
                fail(f"stream {name} {label}: the codes differ between calls with one seed")
        # the codec's own spread: the joint decode in the precision's dtype and
        # in float32, against which the stream must do as well as the joint
        joint = pcm(tts._decode_codes(codes))
        padded = np.zeros((1, codes.shape[0], _vocoder_bucket(codes.shape[1])), np.int64)
        padded[0, :, :codes.shape[1]] = codes
        ref32 = pcm(vocoder.dac_decode(vp32, vcfg, torch.as_tensor(padded, device=tts.device))[
            0, 0, :len(joint)].cpu().numpy())
        err = {k: int(np.abs(v - w).max()) for k, (v, w) in {
            "stream-joint": (s["pcm"], joint), "stream-fp32": (s["pcm"], ref32),
            "joint-fp32": (joint, ref32), "context-fp32": (c["pcm"], ref32)}.items()}
        if (s["pcm"].shape != joint.shape or not err["stream-joint"] <= STREAM_PCM_TOL
                or not err["stream-fp32"] <= STREAM_FP32_RATIO * err["joint-fp32"] + 1):
            fail(f"stream {name} {label}: the stateful stream's PCM is off: {err} (int16 steps; "
                 f"tol {STREAM_PCM_TOL} against the joint decode, {STREAM_FP32_RATIO}x the "
                 f"joint decode's own error against the float32 decode)")
        print(f"stream {name} {label}: streamed codes equal the non-streamed call's "
              f"({batch.shape[1]} frames, 0 differing codes) plus its stripped final frame; "
              f"PCM max errors in int16 steps (peak {int(np.abs(ref32).max())}): stateful "
              f"stream against the joint decode {err['stream-joint']} (tol {STREAM_PCM_TOL}), "
              f"against the float32 decode {err['stream-fp32']} (joint decode {err['joint-fp32']}"
              f", tol {STREAM_FP32_RATIO}x), context mode {err['context-fp32']}", flush=True)
    del vp32

    # the codec per 20-frame chunk: CUDA events around one call, and the
    # device's and the host's time with the host ahead of the device
    codes = torch.as_tensor(codes[None], device=tts.device)
    state = vocoder_stream.init_decode_state(vp, vcfg)
    padded = torch.zeros((1, codes.shape[1], 80), dtype=codes.dtype, device=tts.device)
    padded[:, :, :52] = codes[:, :, :52]
    calls = {"stateful": lambda: vocoder_stream.decode_chunk(vp, vcfg, state, codes[:, :, :20]),
             "context (20 + 32 frames of context, the 80-frame bucket)":
                 lambda: vocoder.dac_decode(vp, vcfg, padded)}
    for mode, fn in calls.items():
        ms = time_ms(fn, 10)
        dev_us, host_us = device_and_host_us(fn, 1)
        print(f"stream {name}: codec per 20-frame chunk, {mode}: {ms:.3f} ms by CUDA events "
              f"(median of 10); device {dev_us / 1e3:.3f} ms, host {host_us / 1e3:.3f} ms "
              f"with the host ahead", flush=True)
    tts.clear_references()
    if fast_decoder.launches_spread != spread:
        fail(f"stream {name}: {fast_decoder.launches_spread - spread} fast-decoder launches "
             f"took the spread attention in a phase of B = 1 frames")
    print(f"stream {name}: fast-decoder launches with the spread attention unchanged "
          f"({spread})", flush=True)


# --- phase 8: batched synthesis ----------------------------------------------------


def batch_texts(B: int) -> list[str]:
    """B texts in two prompt buckets (one for B = 1): TEXT, SHORT_TEXT, ..."""
    return [TEXT if i % 2 == 0 else SHORT_TEXT for i in range(B)]


def batch_sampling(B: int) -> dict:
    """Sampling parameters of a batch: one value per stream, differing
    between streams (SAMPLING's scalars for B = 1)."""
    if B == 1:
        return dict(zip(("temperature", "top_p", "repetition_penalty"), SAMPLING))
    return {"temperature": [0.6 + 0.05 * (i % 4) for i in range(B)],
            "top_p": [0.7 + 0.05 * (i % 5) for i in range(B)],
            "repetition_penalty": [1.0 + 0.05 * (i % 3) for i in range(B)]}


def prompt_groups(engine, texts) -> int:
    """The prompt buckets ``texts`` fall in (the batch's prefills)."""
    import numpy as np

    from fish_tts_tpu_torch.models.prompt import build_prompt

    return len(engine._bucket_groups(np.array([
        build_prompt(engine.tokenizer, t, engine.cfg.num_codebooks).values.shape[1]
        for t in texts])))


def batch_once(tts, name: str, B: int) -> dict:
    """``synthesize_batch`` of B streams after one warm call at that B (its
    graph captures), with every count set to 0 just before the checked call:
    each stream's WAV header and samples ((frames - 1) x 2048), the launches
    of the route at B (once per frame for the whole batch, the sampler and
    fast decoder also once per prompt group's prefill) and every decode
    frame a graph replay.  Prints aggregate frames/s (emitted frames summed
    over the streams, over the call's wall time and over the LM's), RTF and
    the peak device memory of the call."""
    import numpy as np
    import torch

    engine = tts.engine
    texts, kw = batch_texts(B), batch_sampling(B)
    gen_batch, rec = engine.generate_batch, {}

    def timed(*a, **k):
        t = time.perf_counter()
        rec["codes"] = gen_batch(*a, **k)
        torch.cuda.synchronize()
        rec["gen_s"] = time.perf_counter() - t
        return rec["codes"]

    label = f"batch {name} B={B}"
    with mock.patch.object(engine, "generate_batch", timed):
        tts.synthesize_batch(texts, max_tokens=MAX_TOKENS, **kw)  # warm
        zero_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        wavs = tts.synthesize_batch(texts, max_tokens=MAX_TOKENS, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    frames = [c.shape[1] + 1 for c in rec["codes"]]  # generate_batch strips the final frame
    groups = prompt_groups(engine, texts)
    launches, replays, rt = route_counts(engine, label, max(frames) - 1, "batch", batch=B,
                                         prefills=groups)
    hop = tts._vocoder_cfg.frame_length
    samples = 0
    for b, wav in enumerate(wavs):
        with wave.open(io.BytesIO(wav)) as w:
            header = (w.getnchannels(), w.getsampwidth(), w.getframerate())
            n = w.getnframes()
            pcm = np.frombuffer(w.readframes(n), np.int16)
        if wav[:4] != b"RIFF" or header != (1, 2, tts.sample_rate):
            fail(f"{label}: stream {b}: bad WAV header {wav[:4]!r} {header}")
        if not 2 <= frames[b] <= MAX_TOKENS or n != (frames[b] - 1) * hop or not pcm.any():
            fail(f"{label}: stream {b}: {n} samples for {frames[b]} frames")
        samples += n
    fps, lm_fps = sum(frames) / wall, sum(frames) / rec["gen_s"]
    rtf = wall / (samples / tts.sample_rate)
    print(f"{label}: {B} streams in {groups} prompt bucket(s), {frames} frames; "
          f"{wall:.3f} s wall = {fps:.1f} aggregate frames/s, LM {rec['gen_s']:.3f} s = "
          f"{lm_fps:.1f} frames/s; RTF {rtf:.4f}; peak device memory {peak_gb:.2f} GiB; "
          f"kernel launches {json.dumps(launches)} for {replays} decode frames, all replayed "
          f"from captured graphs, 0 eager", flush=True)
    return {"fps": fps, "lm_fps": lm_fps, "rtf": rtf, "peak_gb": peak_gb, "launches": launches}


def batch_codes(engine, B: int, tokens: int):
    """Each stream's codes of a B-stream ``generate_batch`` with the engine
    reseeded to SEED."""
    engine.reseed(SEED)
    return engine.generate_batch(batch_texts(B), max_new_tokens=tokens, **batch_sampling(B))


def batch_stream_call(tts, B: int, mode: str) -> dict:
    """One ``synthesize_batch_stream`` of B streams with the engine reseeded
    to SEED: each stream's PCM chunks and streamed codes, and its time to
    first audio (the call to the first round that holds its chunk)."""
    import numpy as np

    from fish_tts_tpu_torch.engine.generate import GenerationEngine

    engine = tts.engine
    texts, kw = batch_texts(B), batch_sampling(B)
    codes, chunks, ttfa = [[] for _ in texts], [[] for _ in texts], [None] * B
    real = GenerationEngine.generate_batch_stream.__get__(engine)

    def recording(*a, **k):
        for chunk in real(*a, **k):
            for b, c in enumerate(chunk):
                if c is not None:
                    codes[b].append(c)
            yield chunk

    engine.reseed(SEED)
    with mock.patch.object(engine, "generate_batch_stream", recording):
        t = time.perf_counter()
        for rnd in tts.synthesize_batch_stream(texts, max_tokens=MAX_TOKENS, vocoder_mode=mode,
                                               **kw):
            now = time.perf_counter() - t
            if len(rnd) != B:
                fail(f"batch stream {mode}: a round of {len(rnd)} chunks for {B} streams")
            for b, c in enumerate(rnd):
                if c is not None:
                    chunks[b].append(c)
                    ttfa[b] = now if ttfa[b] is None else ttfa[b]
        wall = time.perf_counter() - t
    return {"codes": [np.concatenate(c, axis=1) for c in codes], "chunks": chunks,
            "ttfa": ttfa, "wall": wall,
            "pcm": [np.frombuffer(b"".join(c), np.int16).astype(np.int32) for c in chunks]}


def check_batch_stream(tts, name: str, B: int, batch) -> None:
    """``synthesize_batch_stream`` of B streams in both codec modes, each
    warmed once: chunks of whole frames, the first of at least 10, the
    streamed codes equal to ``batch`` (the non-streamed codes) plus each
    stream's final frame, the launches of the route and every decode frame
    a graph replay; the stateful pool's PCM per stream within
    STREAM_PCM_TOL of the joint decode of its codes, the context mode's
    error printed.  Prints each stream's time to first audio and the whole
    call's aggregate frames/s (STREAM_RUNS timed calls after the checked
    one)."""
    import numpy as np

    hop = tts._vocoder_cfg.frame_length
    groups = prompt_groups(tts.engine, batch_texts(B))
    for mode in ("stateful", "context"):
        label = f"batch {name} B={B} stream {mode}"
        batch_stream_call(tts, B, mode)  # warm
        zero_counts()
        r = batch_stream_call(tts, B, mode)
        n = [c.shape[1] for c in r["codes"]]
        route_counts(tts.engine, label, max(n) - 1, "batch", batch=B, prefills=groups)
        for b in range(B):
            sizes = [len(c) // (2 * hop) for c in r["chunks"][b]]
            if (any(len(c) % (2 * hop) for c in r["chunks"][b]) or sum(sizes) != n[b]
                    or sizes[0] < 10):
                fail(f"{label}: stream {b}: chunks of {sizes} frames for {n[b]} frames")
            if n[b] != batch[b].shape[1] + 1 or not np.array_equal(r["codes"][b][:, :-1],
                                                                    batch[b]):
                fail(f"{label}: stream {b}: the streamed codes are not the non-streamed "
                     f"call's plus its final frame")
        joint = [np.frombuffer(tts._decode_to_pcm(c), np.int16).astype(np.int32)
                 for c in r["codes"]]
        if any(p.shape != j.shape for p, j in zip(r["pcm"], joint)):
            fail(f"{label}: {[len(p) for p in r['pcm']]} samples streamed, the joint decodes "
                 f"give {[len(j) for j in joint]}")
        err = [int(np.abs(p - j).max()) for p, j in zip(r["pcm"], joint)]
        if mode == "stateful" and not max(err) <= STREAM_PCM_TOL:
            fail(f"{label}: PCM against the joint decode off by {err} int16 steps "
                 f"(tol {STREAM_PCM_TOL})")
        runs = [batch_stream_call(tts, B, mode) for _ in range(STREAM_RUNS)]
        print(f"{label}: {n} frames per stream, equal to the non-streamed codes plus the final "
              f"frame; PCM against the joint decode of each stream's codes {err} int16 steps"
              f"{f' (tol {STREAM_PCM_TOL})' if mode == 'stateful' else ''}; time to first "
              f"audio per stream (ms) "
              f"{[[round(x * 1e3, 1) for x in run['ttfa']] for run in runs]}; aggregate "
              f"{[round(sum(n) / run['wall'], 1) for run in runs]} frames/s over "
              f"{STREAM_RUNS} calls", flush=True)


def phase_batch(tts, name: str) -> dict:
    """Batched synthesis on ``tts`` (``name`` its precision): ``synthesize_batch``
    at each of BATCH_SIZES (:func:`batch_once`); at B = 4 the same codes from
    the graph route and the eager loop, and ``synthesize_batch_stream`` in
    both codec modes (:func:`check_batch_stream`).  Returns each B's numbers."""
    import numpy as np

    t0 = time.perf_counter()
    out = {B: batch_once(tts, name, B) for B in BATCH_SIZES}
    engine = tts.engine
    tokens = BATCH_EAGER_TOKENS[name]
    graph = batch_codes(engine, 4, tokens)
    with mock.patch.object(engine, "_decode", eager_route(engine)):
        eager = batch_codes(engine, 4, tokens)
    if not all(g.shape == e.shape and np.array_equal(g, e) for g, e in zip(graph, eager)):
        fail(f"batch {name} B=4: the graph route's codes differ from the eager loop's")
    print(f"batch {name} B=4: graph route and eager loop give equal codes "
          f"({[c.shape[1] for c in graph]} frames per stream)", flush=True)
    check_batch_stream(tts, name, 4, batch_codes(engine, 4, MAX_TOKENS))
    print(f"batch {name}: phase took {time.perf_counter() - t0:.1f} s", flush=True)
    return out


# --- phase 9: continuous-batching serving ------------------------------------------


SERVE_BUDGETS = (40, 70, 100, 130)  # max_new_tokens, cycled over the requests
# (precision, slots, requests, waves, budgets): waves of requests, one wave
# after every second round of the pool
SERVE_CASES = {"int8": (8, 16, 4, SERVE_BUDGETS), "bf16": (4, 6, 2, (20, 30, 40))}
SERVE_REF, SERVE_PRIORITY, SERVE_CANCEL = 5, 9, 2  # request indices (the ref one's group mixes)
SERVE_MAX_ROUNDS = 500


def serve_requests(n: int, budgets, profile) -> list[tuple[str, dict]]:
    """n requests: TEXT and SHORT_TEXT in turns, budgets cycled, a seed and
    sampling parameters of each one's own; request SERVE_REF carries the
    661-frame profile as its references, request SERVE_PRIORITY priority 1."""
    out = []
    for i in range(n):
        kw = dict(max_new_tokens=budgets[i % len(budgets)], seed=SEED + 100 + i,
                  temperature=0.6 + 0.05 * (i % 4), top_p=0.7 + 0.05 * (i % 5),
                  repetition_penalty=1.0 + 0.05 * (i % 3))
        if i == SERVE_REF:
            kw["references"] = [profile]
        if i == SERVE_PRIORITY:
            kw["priority"] = 1
        out.append((TEXT if i % 2 == 0 else SHORT_TEXT, kw))
    return out


class ServeRecorder:
    """Wraps a session: the codes of every LM event by request, the batch
    size of every admission prefill, CUDA events around every round (LM
    chunk, admissions and codec), and a check of every graph capture made
    while it serves (the pool's state and the chunk in flight must come out
    of it untouched)."""

    def __init__(self, sess):
        import torch

        from fish_tts_tpu_torch.engine import decode

        self.codes: dict[int, list] = {}
        self.prefills: list[int] = []
        self.rounds: list[tuple] = []
        self.captures: list[float] = []
        srv, rec = sess._srv, self
        lm_step, step = srv.step, sess.step
        prefill, graph_cls = decode.prefill, decode.DecodeGraph

        def recorded_lm_step():
            events = lm_step()
            for ev in events:
                rec.codes.setdefault(ev.request_id, []).append(ev.codes)
            return events

        def timed_step():  # a whole round: LM chunk, admissions and codec
            with srv.on_stream():
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                events = step()
                b.record()
            rec.rounds.append((a, b))
            return events

        def counted_prefill(params, rope, state, *a, **k):
            rec.prefills.append(state["frame"].shape[0])
            return prefill(params, rope, state, *a, **k)

        class CheckedGraph(graph_cls):
            def __init__(self, params, cfg, ids, rope, state, **kw):
                before = [t.clone() for t in decode._tensors(state)]
                pending = srv._pending
                if pending is not None and pending[2] is not None:
                    pending[2].synchronize()
                held = None if pending is None else (pending[0].clone(), pending[1].clone())
                t = time.perf_counter()
                super().__init__(params, cfg, ids, rope, state, **kw)
                torch.cuda.synchronize()
                rec.captures.append(time.perf_counter() - t)
                if not all(torch.equal(x, y) for x, y in zip(before, decode._tensors(state))):
                    fail("serve: a graph capture mid-serving changed the pool's state")
                if held is not None and not (torch.equal(held[0], pending[0])
                                             and torch.equal(held[1], pending[1])):
                    fail("serve: a graph capture mid-serving changed the chunk in flight")

        srv.step, sess.step = recorded_lm_step, timed_step
        self._unwrap = lambda: (vars(srv).pop("step"), vars(sess).pop("step"))
        self._patches = [mock.patch.object(decode, "prefill", counted_prefill),
                         mock.patch.object(decode, "DecodeGraph", CheckedGraph)]
        for p in self._patches:
            p.start()

    def stop(self) -> None:
        self._unwrap()
        for p in self._patches:
            p.stop()

    def round_ms(self) -> list[float]:
        return [a.elapsed_time(b) for a, b in self.rounds]


def drive_serve(sess, reqs, waves: int, cancel: int | None):
    """Submit ``reqs`` in ``waves`` equal waves, one after every second
    round, and run the session to its end; request ``cancel`` is cancelled
    at its first audio.  Returns (ids, {id: [events]}, the wall time, the
    time of each id's first audio from its submission, the round of the
    cancel)."""
    per = len(reqs) // waves
    ids, events, first, t_sub = [], {}, {}, {}
    cancelled_at, rounds = None, 0

    def submit_wave(w):
        for text, kw in reqs[w * per:(w + 1) * per]:
            rid = sess.submit(text, **kw)
            ids.append(rid)
            t_sub[rid] = time.perf_counter()
            events[rid] = []

    t0 = time.perf_counter()
    submit_wave(0)
    while sess.busy or len(ids) < len(reqs):
        if rounds > SERVE_MAX_ROUNDS:
            fail(f"serve: the session did not drain in {SERVE_MAX_ROUNDS} rounds")
        if rounds and rounds % 2 == 0 and len(ids) < len(reqs):
            submit_wave(len(ids) // per)
        for ev in sess.step():
            if cancelled_at is not None and ev.request_id == ids[cancel]:
                fail(f"serve: an event for request {cancel} after its cancel")
            events[ev.request_id].append(ev)
            if ev.pcm and ev.request_id not in first:
                first[ev.request_id] = time.perf_counter() - t_sub[ev.request_id]
            if (cancel is not None and cancelled_at is None and len(ids) > cancel
                    and ev.request_id == ids[cancel] and ev.pcm):
                sess.cancel(ev.request_id)
                cancelled_at = rounds
        rounds += 1
    return ids, events, time.perf_counter() - t0, first, cancelled_at


def served_alone(sess, text, kw) -> "np.ndarray":
    """One request served alone in ``sess``'s pool: its LM codes."""
    import numpy as np

    codes = []
    srv = sess._srv
    step = srv.step

    def rec_step():
        events = step()
        codes.extend(ev.codes for ev in events if ev.request_id == rid)
        return events

    srv.step = rec_step
    try:
        rid = sess.submit(text, **kw)
        for _ in sess.run():
            pass
    finally:
        srv.step = step
    return np.concatenate(codes, axis=1)


def solo_codes(tts, text, kw) -> "np.ndarray":
    """The request's solo run: ``reseed(seed)`` and a streamed
    ``generate_long`` with its sampling and references."""
    import numpy as np

    engine = tts.engine
    refs = kw.get("references") or []
    engine.reseed(kw["seed"])
    chunks = [r.codes for r in engine.generate_long(
        text, max_new_tokens=kw["max_new_tokens"], temperature=kw["temperature"],
        top_p=kw["top_p"], repetition_penalty=kw["repetition_penalty"],
        prompt_text=[p.text for p in refs], prompt_tokens=[np.asarray(p.codes) for p in refs],
        streaming=True, use_prefix_cache=False) if r.action == "sample"]
    return np.concatenate(chunks, axis=1)


class DecisionLog:
    """Every sampling decision of the runs made under :meth:`recording`, by
    (noise key, frame): a request's rows carry its own noise key in any run
    (pool, alone or solo), and its frame is its slot's step + 1 (0 for its
    prefill).  Each entry holds "slow", the sampler kernel's (logits,
    prev_col, gumbel, temperature, top_p, penalty, token); "fast", the fast
    decoder's (codes, logits, gumbel, temperature, top_p); "plain", the plain
    route's decisions in order, each (penalized logits, gumbel, temperature,
    top_p, code, top_k).  The first frame recorded under a key and frame
    wins (a done row repeats its step)."""

    def __init__(self):
        self.at: dict[tuple, dict] = {}
        self._rows: list[dict] = []

    def recording(self):
        from contextlib import ExitStack

        from fish_tts_tpu_torch.engine import decode, sampling
        from fish_tts_tpu_torch.ops import fast_decoder, sampler_kernel

        draw, slow_k = decode._draw, sampler_kernel.sample_slow
        fast_k, plain = fast_decoder.fast_decode_frame, decode.sample
        log = self

        def rec_draw(cfg, state, noise, step, draws):
            log._rows = []
            for k, st in zip(state["noise_key"].tolist(), step.tolist()):
                entry = {"plain": []}
                log.at.setdefault((k, 0 if st == decode.PREFILL_STEP else st + 1), entry)
                log._rows.append(entry)
            return draw(cfg, state, noise, step, draws)

        def rows(*xs):
            return [tuple(x[b:b + 1].clone() for x in xs) for b in range(len(log._rows))]

        def rec_slow(logits, prev_col, g, t, p, r, skip=None):
            token = slow_k(logits, prev_col, g, t, p, r, skip)
            for e, row in zip(log._rows, rows(logits, prev_col, g, t, p, r, token)):
                e["slow"] = row
            return token

        def rec_fast(params, cfg, rope, h, a0, prev, g, t, p, r, **kw):
            codes, logits = fast_k(params, cfg, rope, h, a0, prev, g, t, p, r, **kw)
            for e, row in zip(log._rows, rows(codes, logits, g, t, p)):
                e["fast"] = row
            return codes, logits

        def rec_plain(g, logits, t, p, r, prev_idx=None, top_k=0, approx=False):
            code = plain(g, logits, t, p, r, prev_idx, top_k=top_k, approx=approx)
            pen = logits.float()
            if prev_idx is not None:
                pen = sampling.apply_repetition_penalty(pen, prev_idx, r)
            for e, row in zip(log._rows, rows(pen, g, t, p, code)):
                e["plain"].append(row + (top_k,))
            return code

        stack = ExitStack()
        for obj, name, fn in ((decode, "_draw", rec_draw), (sampler_kernel, "sample_slow", rec_slow),
                              (fast_decoder, "fast_decode_frame", rec_fast),
                              (decode, "sample", rec_plain)):
            stack.enter_context(mock.patch.object(obj, name, fn))
        return stack


def eager_session(tts, slots: int):
    """A session of ``slots`` whose pool decodes on the eager loop."""
    from fish_tts_tpu_torch.engine import decode

    sess = tts.serve(slots=slots, warmup=False)
    srv, engine = sess._srv, tts.engine

    def eager_pool(kv_b):
        _, frames, emitted = decode.decode_chunk(
            engine.params, engine.rope, srv._state, None, *srv._state["sampling"],
            cfg=engine.cfg, ids=engine.ids, num_frames=srv.chunk, kv_bucket=kv_b,
            early_exit=True, **engine._options)
        return frames, emitted

    srv._decode = eager_pool
    return sess


def first_decision(entry: dict) -> list:
    """A frame's picks from its log entry, in frame order: the slow token,
    then each residual book."""
    picks = [int(entry["slow"][6][0])] if "slow" in entry else []
    if "fast" in entry:
        picks += entry["fast"][0][0].tolist()
    return picks + [int(p[4][0]) for p in entry["plain"]]


def knife_edge(got_log, ref_log, key: int, got, ref, label: str) -> int:
    """The first decision where the run logged in ``got_log`` (codes
    ``got``) of the request with noise key ``key`` differs from the
    reference run (``ref_log``, codes ``ref``), held as a knife edge of the
    reference's own numbers: the two runs' logits there lie within
    STACK_TOL of the reference's largest (a whole 28-layer call's
    tolerance), the other inputs are equal, and the reference's decision
    lies within the logits' difference of its boundary
    (``testing.sample_decision_margins`` for the slow token and a plain
    route's book, ``testing.fast_decision_margins`` for the fast
    decoder's).  The slow token is compared itself, not the code ``a``
    clamped from it.  Returns the frame."""
    import torch

    from fish_tts_tpu_torch.testing import fast_decision_margins, sample_decision_margins

    n = min(got.shape[1], ref.shape[1])
    f = row = None
    for f in range(n):
        mine, theirs = first_decision(got_log.at[(key, f)]), first_decision(ref_log.at[(key, f)])
        diff = [j for j, (x, y) in enumerate(zip(mine, theirs)) if x != y]
        if diff:
            row = diff[0]
            break
    if row is None:
        fail(f"{label}: the codes differ but no decision in their first {n} frames does")
    a, b = got_log.at[(key, f)], ref_log.at[(key, f)]

    def same(xs, ys):
        return all(torch.equal(x, y) for x, y in zip(xs, ys))

    slow_plain = "slow" not in b
    if row == 0 and not slow_plain:
        l8, prev, g, t, p, r, tok8 = a["slow"]
        l1, *inputs, tok1 = b["slow"]
        if not same(inputs, (prev, g, t, p, r)):
            fail(f"{label}: frame {f}: the slow token's inputs differ beyond its logits")
        tol = (l8.float() - l1.float()).abs().max().item()
        lanes = torch.arange(l1.shape[1], device=l1.device)
        hit = (lanes[None, None, :] == prev.long()[:, :, None]).any(dim=1)
        ref_l = l1.float()
        ref_l = torch.where(hit, torch.where(ref_l < 0, ref_l * r, ref_l / r), ref_l)
        m = sample_decision_margins(tok8, tok1, ref_l, g, t, p, -1, tol)
    elif "fast" in b:
        c8, lg8, g, t, p = a["fast"]
        c1, ref_l, *inputs = b["fast"]
        if not same(inputs, (g, t, p)):
            fail(f"{label}: frame {f}: the fast decoder's inputs differ beyond its hidden state")
        tol = (lg8[:, :row].float() - ref_l[:, :row].float()).abs().max().item()
        m = fast_decision_margins(c8, c1, lg8, ref_l, g, t, p, tol)
    else:
        l8, g, t, p, code8, top_k = a["plain"][row - 1 + slow_plain]
        ref_l, *inputs, code1, _ = b["plain"][row - 1 + slow_plain]
        if not same(inputs, (g, t, p)):
            fail(f"{label}: frame {f} decision {row}: the inputs differ beyond the logits")
        tol = (l8 - ref_l).abs().max().item()
        m = sample_decision_margins(code8, code1, ref_l, g, t, p, top_k, tol)
    scale = ref_l.float().abs().max().item()
    if m["failures"] or not m["knife_edges"] or not tol <= STACK_TOL * scale:
        fail(f"{label}: frame {f} decision {row}: the runs differ with no knife edge "
             f"({m['failures']}; logits differ by {tol:.3g}, tol {STACK_TOL * scale:.3g})")
    return f


def phase_serve(tts, name: str) -> None:
    """``tts.serve`` on ``tts`` (``name`` its precision; SERVE_CASES its
    slots, requests, waves and budgets): requests submitted in waves into a
    running pool (one with a 661-frame reference, one with priority 1, one
    cancelled at its first audio).  Checks: every kernel launched once per
    pool decode frame plus the sampler and the fast decoder once per
    admitted request's prefill, every decode frame a graph replay; each
    request's codes equal to its codes served alone in a pool of the same
    slots (co-tenant invariance, exact on every route), and to its solo
    B = 1 run or differing first at a knife edge (:func:`knife_edge`, both
    runs repeated on the eager loop); its PCM frames x 2048 samples and
    within STREAM_PCM_TOL of the joint decode of its codes; no event for the
    cancelled request after its cancel; every graph capture mid-serving
    leaves the pool's state and the chunk in flight untouched.  Prints the
    aggregate frames/s, ``stats()`` over the waved requests alone, device ms
    per round, the graph captures and their time, the allocations and the
    peak device memory."""
    import numpy as np
    import torch

    from fish_tts_tpu_torch.engine import decode
    from fish_tts_tpu_torch.ops import fast_decoder

    slots, n, waves, budgets = SERVE_CASES[name]
    label = f"serve {name} slots={slots}"
    t_phase = time.perf_counter()
    t = time.perf_counter()
    before = tts.get_metrics()["phases"].get("graph.capture", {"count": 0, "total_s": 0.0})
    sess = tts.serve(slots=slots, warmup=True)
    torch.cuda.synchronize()
    srv = sess._srv
    after = tts.get_metrics()["phases"].get("graph.capture", {"count": 0, "total_s": 0.0})
    print(f"{label}: session built and warmed up in {time.perf_counter() - t:.1f} s "
          f"({after['count'] - before['count']} graph(s) captured in "
          f"{after['total_s'] - before['total_s']:.2f} s, the graph.capture span)", flush=True)
    reqs = serve_requests(n, budgets, reference_profile(tts._cfg))
    cancel = SERVE_CANCEL
    rec = ServeRecorder(sess)
    zero_counts()
    spread0 = fast_decoder.launches_spread
    torch.cuda.reset_peak_memory_stats()
    allocs0 = len(srv.allocs)
    try:
        ids, events, wall, first, cancelled_at = drive_serve(sess, reqs, waves, cancel)
        torch.cuda.synchronize()
    finally:
        rec.stop()
    st = sess.stats()
    launches = kernel_counts()
    spread = fast_decoder.launches_spread - spread0
    replays, eager = decode.graph_replays, decode.eager_frames
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    W = tts.engine.engine_cfg.rep_penalty_window

    def rt(B):
        return decode.route(tts._cfg, tts.engine.params, B, W, **tts.engine._options)

    pool = rt(slots)
    want = {"sample_slow": pool.sampler * replays + sum(rt(g).sampler for g in rec.prefills),
            **stack_counts(tts._cfg, pool.slow_stack * replays),
            "fast_decode_frame": pool.fast * replays + sum(rt(g).fast for g in rec.prefills),
            S8: 0}
    if launches != want or eager or not replays:
        fail(f"{label}: kernel launches {launches} with {replays} graph replays, {eager} eager "
             f"frames and {len(rec.prefills)} admissions; the routes imply {want}")
    # the fast decoder's spread attention: every pool frame at B >= 2 (so
    # some, as replays > 0), no admission prefill of one request
    want_spread = pool.fast * replays * (slots >= 2) + sum(rt(g).fast for g in rec.prefills
                                                           if g >= 2)
    if spread != want_spread:
        fail(f"{label}: {spread} fast-decoder launches with the spread attention, the routes "
             f"imply {want_spread}")
    print(f"{label}: {spread} fast-decoder launches with the spread attention of "
          f"{launches['fast_decode_frame']}", flush=True)
    tally("serve", launches)
    if cancelled_at is None:
        fail(f"{label}: request {cancel} never reached its first audio")

    hop = tts._vocoder_cfg.frame_length
    frames, served, alone, solo = [], {}, {}, {}
    for i, (rid, (text, kw)) in enumerate(zip(ids, reqs)):
        evs = events[rid]
        served[i] = np.concatenate(rec.codes[rid], axis=1)
        alone[i] = served_alone(sess, text, kw)
        frames.append(evs[-1].frames_total)
        if i == cancel:
            if any(e.done for e in evs):
                fail(f"{label}: the cancelled request got a done event")
            alone[i] = alone[i][:, :served[i].shape[1]]
            continue
        if sum(e.done for e in evs) != 1 or not evs[-1].done:
            fail(f"{label}: request {i}: {sum(e.done for e in evs)} done events")
        pcm = np.frombuffer(b"".join(e.pcm for e in evs), np.int16).astype(np.int32)
        n_frames = frames[-1]
        if not (n_frames == served[i].shape[1] <= kw["max_new_tokens"]
                and len(pcm) == n_frames * hop):
            fail(f"{label}: request {i}: {len(pcm)} samples for {n_frames} frames "
                 f"({served[i].shape[1]} codes, budget {kw['max_new_tokens']})")
        joint = np.frombuffer(tts._decode_to_pcm(served[i]), np.int16).astype(np.int32)
        err = int(np.abs(pcm - joint).max())
        if not err <= STREAM_PCM_TOL or not np.abs(joint).max():
            fail(f"{label}: request {i}: PCM against the joint decode off by {err} int16 steps")
        solo[i] = solo_codes(tts, text, kw)
    alone_diff = [i for i in served if not np.array_equal(served[i], alone[i])]
    solo_diff = [i for i in solo if not np.array_equal(served[i], solo[i])]
    if alone_diff:
        fail(f"{label}: requests {alone_diff}: their codes differ from their codes served alone")
    solo_edges = []
    if solo_diff:
        # held as knife edges: the served run again on the eager loop, then
        # each differing request's solo run, every decision recorded
        served_log, replay = DecisionLog(), eager_session(tts, slots)
        replayed = ServeRecorder(replay)
        with served_log.recording():
            r_ids = drive_serve(replay, reqs, waves, cancel)[0]
        replayed.stop()
        if any(not np.array_equal(np.concatenate(replayed.codes[r], axis=1), served[i])
               for i, r in enumerate(r_ids)):
            fail(f"{label}: the eager loop does not repeat the served codes")
        for i in solo_diff:
            text, kw = reqs[i]
            key = tts.engine._seed_noise(kw["seed"]).slot_keys([0])[0]
            log = DecisionLog()
            with log.recording(), mock.patch.object(tts.engine, "_decode",
                                                    eager_route(tts.engine)):
                again = solo_codes(tts, text, kw)
            if not np.array_equal(again, solo[i]):
                fail(f"{label}: request {i}: the eager loop does not repeat its solo run")
            solo_edges.append((i, knife_edge(served_log, log, key, served[i], solo[i],
                                             f"{label}: request {i} against its solo run")))
    torch.cuda.synchronize()
    rounds = rec.round_ms()
    fps = sum(frames) / wall
    print(f"{label}: {n} requests in {waves} waves ({len(rec.prefills)} admissions, each "
          f"prefilled alone), {sum(frames)} frames {frames}; {wall:.3f} s wall = {fps:.1f} "
          f"aggregate frames/s over {len(rounds)} rounds, device {statistics.median(rounds):.2f} "
          f"ms per round (median; mean {statistics.mean(rounds):.2f}); peak device memory "
          f"{peak_gb:.2f} GiB", flush=True)
    print(f"{label}: stats() time to first frames p50 {st['ttft_p50_s'] * 1e3:.1f} ms, p95 "
          f"{st['ttft_p95_s'] * 1e3:.1f} ms; queue wait p50 {st['queue_wait_p50_s'] * 1e3:.1f} "
          f"ms, p95 {st['queue_wait_p95_s'] * 1e3:.1f} ms; time to first audio per request "
          f"(ms) {[round(first[r] * 1e3, 1) for r in ids if r in first]}", flush=True)
    print(f"{label}: {len(rec.captures)} graph capture(s) while serving, "
          f"{sum(rec.captures):.2f} s, each leaving the pool's state and the chunk in flight "
          f"untouched; allocations {srv.allocs[allocs0 - 1:]}; kernel launches "
          f"{json.dumps(launches)} for {replays} decode frames, all replayed from captured "
          f"graphs, 0 eager", flush=True)
    print(f"{label}: against its codes served alone in a {slots}-slot pool: {n} of {n} equal; "
          f"against its solo B=1 run: "
          f"{len(solo) - len(solo_edges)} of {len(solo)} equal, {len(solo_edges)} at a knife edge "
          f"{solo_edges}; PCM within {STREAM_PCM_TOL} int16 steps of the joint decode; request "
          f"{cancel} cancelled at its first audio, no event after", flush=True)
    print(f"{label}: phase took {time.perf_counter() - t_phase:.1f} s", flush=True)


# --- phase 10: the codec encoder and long text ---------------------------------------


ENCODE_SECONDS = 30  # the synthetic reference: about a 661-frame profile's length
ENCODE_RUNS = 3  # timed encodes of each WAV, after a first one
ENCODE_TEXT = "A sentence the smoke synthesized, encoded back into a voice."
# The card's codes against the CPU's float32 encode: a differing code is
# excused where the CPU's float64 similarities of the two codebook entries
# are this close (cosines of normalized 8-dimensional vectors): tight for the
# codec cast to float32 on the card (convolutions summed in another order),
# wider for the instance's bf16 codec (bf16 activations through the
# encoder).  The bf16 limits sit between the bf16 codec's readings (latent
# 1.04e-2, widest excused gap 0.0119: PERF.md) and a control that must
# break both, the same encode with every weight rounded to 4 significant
# bits (``coarse_bf16``).
VQ_TIE_MARGIN = {"fp32": 1e-3, "bf16": 2.5e-2}
ENCODE_LATENT_TOL = {"fp32": 1e-3, "bf16": 2.5e-2}  # the latent, relative to its largest


def coarse_bf16(t):
    """A bf16 tensor rounded to 4 significant bits (3 of its 7 mantissa
    bits, ties away from zero): the encode control's weights."""
    import torch

    if t.dtype != torch.bfloat16:
        return t
    u = (t.contiguous().view(torch.int16).to(torch.int32) & 0xFFFF) + 8
    u = u & 0xFFF0
    return torch.where(u >= 0x8000, u - 0x10000, u).to(torch.int16).view(torch.bfloat16)


def synthetic_wav(seconds: float, rate: int) -> bytes:
    """A speech-like WAV from a seed: a gliding tone with one overtone under
    a syllable-rate envelope, plus noise."""
    import numpy as np

    from fish_tts_tpu_torch.utils.audio import to_wav_bytes

    rng = np.random.default_rng(SEED + 31)
    t = np.arange(int(seconds * rate)) / rate
    phase = 2 * np.pi * np.cumsum(140 + 60 * np.sin(2 * np.pi * 0.3 * t)) / rate
    x = 0.3 * np.sin(phase) + 0.12 * np.sin(2 * phase) + 0.03 * rng.standard_normal(len(t))
    return to_wav_bytes((x * (0.4 + 0.6 * np.abs(np.sin(2 * np.pi * 2.1 * t)))).astype(
        np.float32), rate)


def phase_encode(tts, seen, wav: bytes):
    """The codec encoder on ``tts`` (int8: a bf16 codec): ``encode_reference``
    of ``wav`` (phase 5's first WAV) twice, bit-equal; its latent
    (``encoder_forward``) and codes against ``dac_encode`` of the same
    padded audio on the CPU in float32, and the same for the codec cast to
    float32 on the card: the latent by its largest relative error, the codes
    equal per frame up to a first differing book that must be a near tie of
    the CPU's own float64 similarities (VQ_TIE_MARGIN; the count printed),
    and a control, the bf16 encode with coarse weights (``coarse_bf16``),
    that must break both bf16 limits.  Then encode times (CUDA-synchronised
    wall, ENCODE_RUNS after a first call) of ``wav`` and of a synthetic
    ENCODE_SECONDS WAV with the peak device memory of its encode, and one
    ``synthesize`` with ``wav``'s profile as the reference.  Returns that
    profile."""
    import numpy as np
    import torch

    from fish_tts_tpu_torch.models import vocoder
    from fish_tts_tpu_torch.synthesizer import _vocoder_bucket
    from fish_tts_tpu_torch.testing import vq_decision_margins
    from fish_tts_tpu_torch.utils import checkpoint as ckpt
    from fish_tts_tpu_torch.utils.audio import read_wav

    vcfg, dev = tts._vocoder_cfg, tts.device
    fl, K = vcfg.frame_length, vcfg.num_codebooks

    def timed(w: bytes):
        times, out = [], None
        for _ in range(1 + ENCODE_RUNS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            prof = tts.encode_reference(w, ENCODE_TEXT)
            times.append((time.perf_counter() - t) * 1e3)
            if out is not None and not np.array_equal(prof.codes, out.codes):
                fail("encode: two encodes of one WAV differ")
            out = prof
        return out, times

    profile, times = timed(wav)
    audio = read_wav(wav, tts.sample_rate)
    n = -(-len(audio) // fl)
    if profile.codes.shape != (K, n) or profile.codes.dtype != np.int64:
        fail(f"encode: codes {profile.codes.shape} {profile.codes.dtype} for {len(audio)} "
             f"samples, want ({K}, {n}) int64")
    x = np.zeros((1, 1, _vocoder_bucket(n) * fl), np.float32)
    x[0, 0, :len(audio)] = audio
    x = torch.from_numpy(x)
    t = time.perf_counter()
    cpu32 = ckpt.to_device(tts._vocoder_params, "cpu", torch.float32)
    lat_cpu = vocoder.encoder_forward(cpu32["encoder"], vcfg, x)
    z_cpu = vocoder.quantizer_latent(cpu32["quantizer"], vcfg, lat_cpu)
    codes_cpu = vocoder.vq_encode(cpu32["quantizer"], z_cpu)[:, :, :n]
    cpu_s = time.perf_counter() - t
    card32 = ckpt.to_device(tts._vocoder_params, dev, torch.float32)
    notes = []
    for name, params, codes in (
            ("bf16", tts._vocoder_params, torch.from_numpy(profile.codes[None])),
            ("fp32", card32, vocoder.dac_encode(card32, vcfg, x.to(dev))[:, :, :n])):
        dtype = params["encoder"]["stem"]["w"].dtype
        with torch.no_grad():
            lat = vocoder.encoder_forward(params["encoder"], vcfg, x.to(dev, dtype))
        lat_err = rel_err(lat.cpu(), lat_cpu)[1]
        m = vq_decision_margins(codes, codes_cpu, cpu32["quantizer"], z_cpu[:, :, :n],
                                VQ_TIE_MARGIN[name])
        if m["failures"] or not lat_err <= ENCODE_LATENT_TOL[name]:
            fail(f"encode {name}: latent rel err {lat_err:.3g} (tol "
                 f"{ENCODE_LATENT_TOL[name]}); " + "; ".join(m["failures"][:8]))
        equal = int((codes.cpu() == codes_cpu).all(dim=1).sum())
        notes.append(f"{name} codec: latent rel err {lat_err:.3g} (tol "
                     f"{ENCODE_LATENT_TOL[name]}), {equal} of {n} frames' codes equal, "
                     f"{m['near_ties']} differing first at a near tie (widest gap "
                     f"{m['worst_gap']:.3g}, margin {VQ_TIE_MARGIN[name]})")
    # the control: the bf16 encode with coarse weights must break both limits
    coarse = ckpt._tree_map(coarse_bf16, tts._vocoder_params)
    with torch.no_grad():
        lat = vocoder.encoder_forward(coarse["encoder"], vcfg, x.to(dev, torch.bfloat16))
        codes = vocoder.vq_encode(coarse["quantizer"],
                                  vocoder.quantizer_latent(coarse["quantizer"], vcfg, lat))
    lat_err = rel_err(lat.cpu(), lat_cpu)[1]
    m = vq_decision_margins(codes[:, :, :n], codes_cpu, cpu32["quantizer"], z_cpu[:, :, :n],
                            VQ_TIE_MARGIN["bf16"])
    gaps = [float(f.split("gap ")[1].split(" ")[0]) for f in m["failures"]]
    note = (f"control (bf16 weights at 4 significant bits): latent rel err {lat_err:.3g}, "
            f"{len(m['failures'])} frames differing first beyond the margin (gaps up to "
            f"{max(gaps, default=0.0):.3g}), {m['near_ties']} at a near tie")
    if not (lat_err > ENCODE_LATENT_TOL["bf16"] and m["failures"]):
        fail(f"encode: the bf16 limits would pass the {note}")
    notes.append(note)
    del card32, cpu32, coarse
    torch.cuda.empty_cache()
    print(f"encode: the {n}-frame WAV of phase 5 ({len(audio) / tts.sample_rate:.2f} s) on the "
          f"card against the CPU's float32 encode ({cpu_s:.1f} s on the CPU): "
          + "; ".join(notes), flush=True)
    print(f"encode: {n} frames in {statistics.median(times[1:]):.1f} ms (median of "
          f"{ENCODE_RUNS} after a first call of {times[0]:.1f} ms; bucket "
          f"{_vocoder_bucket(n)} frames); two encodes bit-equal", flush=True)

    long_wav = synthetic_wav(ENCODE_SECONDS, tts.sample_rate)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    long_profile, times = timed(long_wav)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    n_long = -(-ENCODE_SECONDS * tts.sample_rate // fl)
    if long_profile.codes.shape != (K, n_long):
        fail(f"encode: {long_profile.codes.shape} codes for {ENCODE_SECONDS} s")
    print(f"encode: a synthetic {ENCODE_SECONDS} s WAV, {n_long} frames (bucket "
          f"{_vocoder_bucket(n_long)}), in {statistics.median(times[1:]):.1f} ms (median of "
          f"{ENCODE_RUNS} after a first call of {times[0]:.1f} ms); peak device memory "
          f"{peak:.2f} GiB above the {base / 2**30:.2f} GiB held before it", flush=True)
    synthesize_once(tts, seen, f"synthesize with the encoded {n}-frame profile",
                    references=[profile], path="encode")
    return profile


LONG_TEXT = ("The first sentence of a longer passage is spoken here. A second sentence "
             "follows it closely after. And then a third one ends the passage for today.")
LONG_MAX_CHARS = 80
LONG_TOKENS = 40  # frames per text chunk: the random weights never sample EOS
LONG_CARRY = 64  # carry_frames, synthesize_long's default
LONG_RUNS = 3  # timed calls of each stream, after the checked ones


def phase_long(tts) -> None:
    """Long text on ``tts`` (int8): ``synthesize_long_stream`` of LONG_TEXT,
    which ``split_text(max_chars=LONG_MAX_CHARS)`` cuts into 3 chunks, at
    LONG_TOKENS frames a chunk, warmed once.  Checked, with the engine
    reseeded: 3 chunk calls, each kernel's launches those of the route with
    every decode frame a graph replay (path "long"), the PCM 2048 samples a
    frame of every chunk, ``synthesize_long``'s WAV samples after the same
    reseed equal to that PCM, and chunk 2 prompted with chunk 1's text and
    its last frames but the EOS frame (its prefill length that of the
    prompt built from them).  Then with the 661-frame profile stored: only
    chunk 1 through the prefix, forked once, chunk 2 prefilling the profile
    and the carry.  Prints the time to first audio beside
    ``synthesize_stream``'s (median of LONG_RUNS calls each)."""
    import numpy as np
    import torch

    from fish_tts_tpu_torch.engine import decode
    from fish_tts_tpu_torch.models.prompt import build_prompt
    from fish_tts_tpu_torch.utils.text import split_text

    engine, hop = tts.engine, tts._vocoder_cfg.frame_length
    chunks = split_text(LONG_TEXT, LONG_MAX_CHARS)
    if len(chunks) != 3:
        fail(f"long: split_text gave {len(chunks)} chunks, want 3")
    kw = dict(max_chars=LONG_MAX_CHARS, max_tokens_per_chunk=LONG_TOKENS,
              carry_frames=LONG_CARRY)
    t = time.perf_counter()
    list(tts.synthesize_long_stream(LONG_TEXT, **kw))  # warm: graph captures
    warm_s = time.perf_counter() - t

    calls, prefills, forks = [], [], []
    real_gen, real_prefill, real_fork = engine.generate_long, decode.prefill, engine._fork_prefix

    def gen_spy(text, **k):
        codes = []
        calls.append((text, list(k["prompt_text"]), [np.asarray(c) for c in k["prompt_tokens"]],
                      k["use_prefix_cache"], codes))
        for r in real_gen(text, **k):
            if r.action == "sample":
                codes.append(r.codes)
            yield r

    def prefill_spy(params, rope, state, prompt, lengths, *a, **k):
        prefills.append(int(lengths[0]))
        return real_prefill(params, rope, state, prompt, lengths, *a, **k)

    def fork_spy(*a, **k):
        forks.append(1)
        return real_fork(*a, **k)

    def run(references=None):
        calls.clear()
        prefills.clear()
        forks.clear()
        engine.reseed(SEED + 40)
        zero_counts()
        t = time.perf_counter()
        first, pcm = None, []
        for c in tts.synthesize_long_stream(LONG_TEXT, references=references, **kw):
            first = time.perf_counter() - t if first is None else first
            pcm.append(c)
        torch.cuda.synchronize()
        return pcm, first, time.perf_counter() - t

    def prompt_len(text, texts, codes) -> int:
        return build_prompt(engine.tokenizer, text, engine.cfg.num_codebooks,
                            prompt_texts=texts, prompt_codes=codes).values.shape[1]

    engine.generate_long, engine._fork_prefix = gen_spy, fork_spy
    try:
        with mock.patch.object(decode, "prefill", prefill_spy):
            pcm, first, wall = run()
            per_call = [sum(c.shape[1] for c in call[4]) for call in calls]
            frames = sum(per_call)
            launches, replays, _ = route_counts(engine, "long", 3 * (LONG_TOKENS - 1), "long",
                                                prefills=3)
            if len(calls) != 3 or [c[0] for c in calls] != chunks:
                fail(f"long: chunk calls {[c[0] for c in calls]}, want {chunks}")
            sizes = [len(c) for c in pcm]
            if any(n % (2 * hop) for n in sizes) or sum(sizes) != 2 * hop * frames:
                fail(f"long: PCM chunks of {sizes} bytes for {frames} frames")
            first_codes = np.concatenate(calls[0][4], axis=1)
            carry = first_codes[:, :-1][:, -LONG_CARRY:]
            _, texts, codes, prefix, _ = calls[1]
            if texts != [chunks[0]] or len(codes) != 1 or not np.array_equal(codes[0], carry) \
                    or prefix or prefills[1] != prompt_len(chunks[1], texts, codes):
                fail(f"long: chunk 2 prompted with {texts}, codes "
                     f"{[c.shape for c in codes]} (want the {carry.shape[1]} frames of chunk 1 "
                     f"but its last), prefix {prefix}, prefill of {prefills[1]} tokens")
            engine.reseed(SEED + 40)
            wav = tts.synthesize_long(LONG_TEXT, **kw)
            with wave.open(io.BytesIO(wav)) as w:
                samples = w.readframes(w.getnframes())
            if samples != b"".join(pcm):
                fail(f"long: synthesize_long's WAV ({len(samples)} bytes of samples) differs "
                     f"from the stream's PCM ({sum(sizes)} bytes)")
            print(f"long: {len(chunks)} chunks of {[len(c) for c in chunks]} characters, "
                  f"{per_call} frames; PCM chunks of "
                  f"{[n // (2 * hop) for n in sizes]} frames; synthesize_long's WAV samples "
                  f"equal; chunk 2 prompted with chunk 1's text and {carry.shape[1]} carried "
                  f"frames ({prefills[1]}-token prefill); kernel launches "
                  f"{json.dumps(launches)}, {replays} graph replays, 0 eager; warm-up call "
                  f"{warm_s:.2f} s, checked call {wall:.2f} s", flush=True)

            profile = reference_profile(tts._cfg)
            tts.set_references([profile])
            try:
                run()
            finally:
                tts.clear_references()
            flags = [c[3] for c in calls]
            _, texts, codes, _, _ = calls[1]
            carry = np.concatenate(calls[0][4], axis=1)[:, :-1][:, -LONG_CARRY:]
            want = prompt_len(chunks[1], [profile.text, chunks[0]], [profile.codes, carry])
            if flags != [True, False, False] or len(forks) != 1 or texts != [
                    profile.text, chunks[0]] or prefills[1] != want:
                fail(f"long with the stored profile: prefix flags {flags}, {len(forks)} forks, "
                     f"chunk 2 prompted with {texts}, a prefill of {prefills[1]} tokens (want "
                     f"{want})")
            print(f"long with the stored {REF_FRAMES}-frame profile: chunk 1 through the prefix "
                  f"(prefill of {prefills[0]} tokens), forked once; chunks 2-3 prefill the "
                  f"profile and the carry ({prefills[1]} and {prefills[2]} tokens)", flush=True)
    finally:
        engine.generate_long, engine._fork_prefix = real_gen, real_fork

    long_ttfa, stream_ttfa = [], []
    for _ in range(LONG_RUNS):
        long_ttfa.append(run()[1] * 1e3)
        t, first = time.perf_counter(), None
        for _ in tts.synthesize_stream(TEXT, max_tokens=LONG_TOKENS):
            first = time.perf_counter() - t if first is None else first
        torch.cuda.synchronize()
        stream_ttfa.append(first * 1e3)
    print(f"long: time to first audio {statistics.median(long_ttfa):.1f} ms "
          f"({[round(x, 1) for x in long_ttfa]}), synthesize_stream's "
          f"{statistics.median(stream_ttfa):.1f} ms ({[round(x, 1) for x in stream_ttfa]}); "
          f"medians of {LONG_RUNS} calls each", flush=True)


def http_post(addr, path: str, body: dict):
    import http.client

    conn = http.client.HTTPConnection(*addr, timeout=300)
    conn.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
    r = conn.getresponse()
    out = r.status, r.headers.get("Content-Type"), r.headers.get("X-Request-Id"), r.read()
    conn.close()
    return out


def http_get(addr, method: str, path: str, body: str | None = None):
    import http.client

    conn = http.client.HTTPConnection(*addr, timeout=120)
    conn.request(method, path, body)
    r = conn.getresponse()
    out = r.status, r.read()
    conn.close()
    return out


def phase_http(tts, voice_wav: bytes, profile) -> None:
    """``serving.http.make_server`` on ``tts`` on loopback with 4 slots: two
    concurrent ``POST /synthesize`` (L16 and WAV), each PCM equal to a
    ``ServeSession``'s with the same requests; ``POST /v1/audio/speech``
    (WAV); ``GET /stats`` and ``/metrics``; ``PUT /voices/smoke`` with
    ``voice_wav`` (``profile`` is its encode), then ``GET /voices`` lists it and a
    ``POST /synthesize`` with that voice gives the PCM of a
    ``ServeSession`` request with ``profile`` and the same seed; then the
    driver closed and the server shut down."""
    import base64
    import threading

    from fish_tts_tpu_torch.serving.http import make_server

    t0 = time.perf_counter()
    srv, driver = make_server(tts, host="127.0.0.1", port=0, slots=4)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    addr = srv.server_address
    bodies = [{"text": TEXT, "seed": SEED + 200, "max_new_tokens": 60, "temperature": 0.7},
              {"text": SHORT_TEXT, "seed": SEED + 201, "max_new_tokens": 45, "top_p": 0.9,
               "format": "wav"}]
    got = [None, None]
    try:
        def fetch(i):
            got[i] = http_post(addr, "/synthesize", bodies[i])

        threads = [threading.Thread(target=fetch, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        if any(g is None or g[0] != 200 for g in got):
            fail(f"http: /synthesize answered {[g and g[0] for g in got]}")
        if got[0][1] != "audio/L16" or got[1][1] != "audio/wav" or got[1][3][:4] != b"RIFF":
            fail(f"http: content types {got[0][1]}, {got[1][1]}")
        # the same requests, in the server's order, through a session of its own
        order = sorted(range(2), key=lambda i: int(got[i][2]))
        sess = tts.serve(slots=4, warmup=False)
        rids = {}
        for i in order:
            kw = {k: v for k, v in bodies[i].items() if k not in ("text", "format")}
            rids[sess.submit(bodies[i]["text"], **kw)] = i
        want = [b"", b""]
        for ev in sess.run():
            want[rids[ev.request_id]] += ev.pcm
        pcm = [got[0][3], got[1][3][44:]]
        if pcm != want or not all(pcm):
            fail(f"http: the served PCM ({[len(p) for p in pcm]} bytes) differs from the "
                 f"session's ({[len(w) for w in want]} bytes)")
        status, ctype, _, wav = http_post(addr, "/v1/audio/speech", {
            "model": "tts-1", "input": SHORT_TEXT, "voice": "alloy", "response_format": "wav",
            "seed": SEED + 202, "max_new_tokens": 30})
        if status != 200 or ctype != "audio/wav" or wav[:4] != b"RIFF" or \
                struct.unpack("<I", wav[4:8])[0] != len(wav) - 8:
            fail(f"http: /v1/audio/speech answered {status} {ctype}, {len(wav)} bytes")
        status, body = http_get(addr, "GET", "/stats")
        stats = json.loads(body)
        m_status, metrics = http_get(addr, "GET", "/metrics")
        if status != 200 or stats["completed"] < 3 or m_status != 200 or \
                b"fish_tts_completed " not in metrics:
            fail(f"http: /stats {status} {stats}, /metrics {m_status}")
        # a voice registered from a WAV, then spoken
        t_put = time.perf_counter()
        v_status, v_body = http_get(addr, "PUT", "/voices/smoke", json.dumps(
            {"wav_b64": base64.b64encode(voice_wav).decode(), "text": profile.text}))
        put_s = time.perf_counter() - t_put
        l_status, listed = http_get(addr, "GET", "/voices")
        frames = profile.codes.shape[1]
        if (v_status, json.loads(v_body)) != (200, {"voice": "smoke", "frames": frames}) or \
                (l_status, json.loads(listed)) != (200, {"voices": ["smoke"]}):
            fail(f"http: PUT /voices/smoke {v_status} {v_body!r}, GET /voices {l_status} "
                 f"{listed!r}")
        voiced = {"text": SHORT_TEXT, "voice": "smoke", "seed": SEED + 203, "max_new_tokens": 40}
        status, _, _, voiced_pcm = http_post(addr, "/synthesize", voiced)
        sess.submit(SHORT_TEXT, references=[profile], seed=SEED + 203, max_new_tokens=40)
        want_voiced = b"".join(ev.pcm for ev in sess.run())
        if status != 200 or not voiced_pcm or voiced_pcm != want_voiced:
            fail(f"http: /synthesize with the registered voice answered {status}, "
                 f"{len(voiced_pcm)} bytes, a session's PCM {len(want_voiced)} bytes")
    finally:
        clean = driver.close()
        srv.shutdown()
        thread.join(timeout=30)
    if not clean or thread.is_alive():
        fail("http: the driver or the server did not stop")
    print(f"http: two concurrent /synthesize (L16 {len(pcm[0])} bytes, WAV {len(got[1][3])} "
          f"bytes) equal to a ServeSession's PCM; /v1/audio/speech WAV {len(wav)} bytes; "
          f"/stats {json.dumps(stats)}; /metrics {metrics.count(b'# TYPE')} gauges; "
          f"PUT /voices/smoke registered a {frames}-frame voice in {put_s:.2f} s, GET /voices "
          f"lists it, /synthesize with it {len(voiced_pcm)} bytes equal to a ServeSession's; "
          f"driver and server stopped; {time.perf_counter() - t0:.1f} s", flush=True)


# --- phase 11: the (dp, tp) mesh and the serving codec's own stream ------------------


MESH_FRAMES = 60  # max_tokens of each tp = 2 synthesize
MESH_DP_FRAMES = 30  # max_tokens of the dp = 2 batch
# two texts of one prompt bucket: the batch prefills them as one group, whose
# rows the DP check keys as each text's solo run
MESH_TEXTS = (SHORT_TEXT, "Fine, thank you, and how are you doing?")
MESH_SERVE = 8  # requests of phase_serve's first two waves, submitted at once into 8 slots


def wav_samples(wav: bytes) -> int:
    with wave.open(io.BytesIO(wav)) as w:
        return w.getnframes()


def mesh_instance(bundle, precision: str, **ecfg):
    """A FishTTS at S1-mini width on ``EngineConfig(**ecfg)``: a mesh of two
    handles to the one card when ecfg asks for one, no warmup, seed SEED."""
    import torch

    from fish_tts_tpu_torch import FishTTS
    from fish_tts_tpu_torch.config import EngineConfig

    cfg = EngineConfig(**ecfg)
    devices = [torch.device("cuda", 0)] * 2 if cfg.tp_size * cfg.dp_size > 1 else None
    return FishTTS(device="cuda", precision=precision, warmup=False, seed=SEED,
                   engine_config=cfg, devices=devices, _testing_bundle=bundle)


def mesh_prefill(mesh_tts, plain_tts, label: str) -> str:
    """The prompt's prefill (``slow_forward`` + ``lm_logits``) on the mesh
    instance against the one-device plain one: hidden state and last logits
    within STACK_TOL of the plain version's largest magnitude."""
    import torch

    from fish_tts_tpu_torch.engine import decode
    from fish_tts_tpu_torch.models import dual_ar
    from fish_tts_tpu_torch.models.prompt import build_prompt
    from fish_tts_tpu_torch.ops.attention import NEG_INF

    cfg = plain_tts._cfg
    padded, T = plain_tts.engine._pad_prompt(
        build_prompt(plain_tts.engine.tokenizer, TEXT, cfg.num_codebooks).values)
    out = []
    for e in (mesh_tts.engine, plain_tts.engine):
        t = torch.arange(padded.shape[-1], device=e.device)
        block = torch.where(t[None, :] <= t[:, None], 0.0, NEG_INF)[None, None]
        state = decode.init_state(e.params, cfg, batch=1)
        with torch.no_grad():
            hidden = dual_ar.slow_forward(e.params, cfg, e.ids, e.rope,
                                          torch.as_tensor(padded, device=e.device), t[None],
                                          state["kv"], None, block, read_len=0)
            out.append((hidden[:, :T], dual_ar.lm_logits(e.params, cfg, hidden[:, T - 1:T])))
    (hm, lm), (h1, l1) = out
    h_rel, l_rel = rel_err(hm, h1)[1], rel_err(lm, l1)[1]
    if not (h_rel <= STACK_TOL and l_rel <= STACK_TOL):
        fail(f"{label}: prefill hidden {h_rel:.3g} and logits {l_rel:.3g} of the largest, "
             f"limit {STACK_TOL}")
    return f"prefill of {T} tokens: hidden {h_rel:.3g}, logits {l_rel:.3g} of the largest"


def hold_to_plain(mesh_log, key: int, got, ref, rerun, label: str) -> int | None:
    """``got`` (a mesh run's codes, its decisions recorded in ``mesh_log``)
    against ``ref`` (the one-device plain run's, on its graphs): equal, or
    equal up to a first differing frame f at a knife edge of the plain run's
    own numbers (:func:`knife_edge`): the plain run is repeated for its
    first f + 2 frames on the eager loop with every decision recorded
    (``rerun(n)`` gives the codes of an n-frame run; the frames do not
    depend on the budget).  Returns the frame of the first differing
    decision, None when the codes are equal."""
    import numpy as np

    if np.array_equal(got, ref):
        return None
    n = min(got.shape[1], ref.shape[1])
    cols = np.flatnonzero((got[:, :n] != ref[:, :n]).any(axis=0))
    if not len(cols):
        fail(f"{label}: {got.shape[1]} frames against the plain run's {ref.shape[1]}")
    f = int(cols[0])
    log = DecisionLog()
    with log.recording():
        again = rerun(f + 2)
    if not np.array_equal(again, ref[:, :f + 1]):
        fail(f"{label}: the eager loop does not repeat the plain run's first {f + 1} frames")
    return knife_edge(mesh_log, log, key, got[:, :f + 1], again, label)


def mesh_tp(bundle, precision: str, card: str):
    """``EngineConfig(tp_size=2)`` over two handles to the card against the
    one-device plain route (``fast_kernel=False``): the prefill within
    STACK_TOL; MESH_FRAMES frames of ``synthesize`` from one seed, the mesh
    run's decisions recorded, codes equal up to a first difference at a
    knife edge (:func:`hold_to_plain`), the WAV of every frame.  Returns the
    plain instance."""
    import torch

    label = f"mesh: tp=2 {precision}"
    mesh, plain = mesh_instance(bundle, precision, tp_size=2), mesh_instance(
        bundle, precision, fast_kernel=False)
    if mesh.engine.mesh.shape != {"dp": 1, "tp": 2} or mesh.engine._options["fast_kernel"]:
        fail(f"{label}: mesh {mesh.engine.mesh}, options {mesh.engine._options}")
    note = mesh_prefill(mesh, plain, label)
    seen = {id(t): observe(t) for t in (mesh, plain)}

    def synth(tts, n):
        tts.engine.reseed(SEED)
        wav = tts.synthesize(TEXT, temperature=SAMPLING[0], top_p=SAMPLING[1],
                             repetition_penalty=SAMPLING[2], max_tokens=n)
        codes = seen[id(tts)]["codes"]
        if wav_samples(wav) != codes.shape[1] * tts._vocoder_cfg.frame_length:
            fail(f"{label}: {wav_samples(wav)} samples for {codes.shape[1]} frames")
        return codes

    def rerun(n):
        with mock.patch.object(plain.engine, "_decode", eager_route(plain.engine)):
            return synth(plain, n)

    log, walls = DecisionLog(), []
    for tts in (mesh, plain):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with log.recording() if tts is mesh else contextlib.nullcontext():
            codes = synth(tts, MESH_FRAMES)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t, codes))
    (wall_m, got), (wall_p, ref) = walls
    key = mesh.engine._seed_noise(SEED).slot_keys([0])[0]
    f = hold_to_plain(log, key, got, ref, rerun, label)
    eq = ("codes equal" if f is None else
          f"codes equal up to frame {f}, a knife edge of the plain run's numbers")
    print(f"{label}: {note}; {got.shape[1]} frames, {eq}; synthesize {wall_m:.2f} s on the "
          f"mesh's eager loop with its decisions recorded, {wall_p:.2f} s on the one-device "
          f"plain route's graphs ({card})", flush=True)
    return plain


def mesh_dp(bundle, plain, card: str) -> None:
    """``EngineConfig(dp_size=2)`` over two handles to the card:
    ``synthesize_batch`` of MESH_TEXTS (one prompt group, one stream per dp
    row) for MESH_DP_FRAMES frames, every draw of row b keyed as text b's
    solo run, its decisions recorded; each stream against its solo B = 1 run
    on the one-device plain int8 instance, equal up to a first difference at
    a knife edge (:func:`hold_to_plain`)."""
    import numpy as np
    import torch

    from fish_tts_tpu_torch.engine.decode import GumbelNoise, KeyedNoise

    label = "mesh: dp=2 int8"
    tts = mesh_instance(bundle, "int8", dp_size=2)
    engine = tts.engine
    if engine.mesh.shape != {"dp": 2, "tp": 1} or prompt_groups(engine, MESH_TEXTS) != 1:
        fail(f"{label}: mesh {engine.mesh}, {prompt_groups(engine, MESH_TEXTS)} prompt groups")
    keys = [GumbelNoise(SEED + 10 + b, None).slot_keys([0])[0] for b in range(2)]
    kw = dict(zip(("temperature", "top_p", "repetition_penalty"), SAMPLING))
    seen = {}
    gen_batch = engine.generate_batch

    def rec(*a, **k):
        seen["codes"] = out = gen_batch(*a, **k)
        return out

    log = DecisionLog()
    torch.cuda.synchronize()
    t = time.perf_counter()
    with log.recording(), mock.patch.object(engine, "_next_noise", lambda: KeyedNoise(keys)), \
            mock.patch.object(engine, "generate_batch", rec):
        wavs = tts.synthesize_batch(list(MESH_TEXTS), max_tokens=MESH_DP_FRAMES, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    got = seen["codes"]
    for w, c in zip(wavs, got):
        if wav_samples(w) != c.shape[1] * tts._vocoder_cfg.frame_length:
            fail(f"{label}: {wav_samples(w)} samples for {c.shape[1]} frames")

    def solo(b, n, eager=False):
        with (mock.patch.object(plain.engine, "_decode", eager_route(plain.engine)) if eager
              else contextlib.nullcontext()):
            return np.concatenate([r.codes for r in plain.engine.generate_long(
                MESH_TEXTS[b], max_new_tokens=n, noise=KeyedNoise([keys[b]]), **kw)
                if r.action == "sample"], axis=1)

    notes = []
    for b in range(2):
        f = hold_to_plain(log, keys[b], got[b], solo(b, MESH_DP_FRAMES),
                          lambda n, b=b: solo(b, n, eager=True), f"{label}: stream {b}")
        notes.append(f"stream {b}: {got[b].shape[1]} frames, " + (
            "equal to its solo run" if f is None else f"equal up to frame {f}, a knife edge"))
    print(f"{label}: synthesize_batch of 2 in {wall:.2f} s on the mesh's eager loop with its "
          f"decisions recorded ({card}), one stream per dp row; {'; '.join(notes)}", flush=True)


def serve_codec_stream(tts, card: str, device) -> None:
    """``tts.serve(slots=8)`` with the pool codec on the LM's stream
    (``vocoder_device=None``) and on a stream of its own on ``device``
    (the card, cuda:0): the same MESH_SERVE requests, submitted at
    once; every request's PCM byte-equal between the two; per round the
    host wall time, the LM stream's device time (CUDA events on the pool's
    stream around its step) and the pool codec's (CUDA events on the
    codec's stream around its decode), medians; the kernels launched, every
    decode frame a graph replay (path "vocoder_device")."""
    import torch

    from fish_tts_tpu_torch.engine import decode

    reqs = serve_requests(16, SERVE_BUDGETS, reference_profile(tts._cfg))[:MESH_SERVE]
    pcm, lines = [], []
    for name, vdev in (("None", None), (str(device), device)):
        sess = tts.serve(slots=8, vocoder_device=vdev, warmup=True)
        srv, lm_ev, voc_ev, walls = sess._srv, [], [], []
        lm_step, codec = srv.step, sess._decode

        def timed_lm(lm_step=lm_step, srv=srv):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record(srv._stream)
            events = lm_step()
            b.record(srv._stream)
            lm_ev.append((a, b))
            return events

        def timed_codec(*args, codec=codec):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = codec(*args)
            b.record()
            voc_ev.append((a, b))
            return out

        srv.step, sess._decode = timed_lm, timed_codec
        zero_counts()
        ids = [sess.submit(text, **kw) for text, kw in reqs]
        out = {i: [] for i in ids}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while sess.busy:
            t = time.perf_counter()
            for ev in sess.step():
                out[ev.request_id].append(ev.pcm)
            walls.append(time.perf_counter() - t)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernel_counts()
        if (not all(launches[k] for k in ("sample_slow", "slow_stack_step", "fast_decode_frame"))
                or decode.eager_frames or not decode.graph_replays):
            fail(f"serve vocoder_device={name}: launches {launches}, {decode.graph_replays} "
                 f"graph replays, {decode.eager_frames} eager frames")
        tally("vocoder_device", launches)
        pcm.append([b"".join(out[i]) for i in ids])
        frames = sum(len(p) for p in pcm[-1]) // (2 * tts._vocoder_cfg.frame_length)
        ms = [statistics.median(a.elapsed_time(b) for a, b in evs) for evs in (lm_ev, voc_ev)]
        lines.append(f"vocoder_device={name}: {len(walls)} rounds, {frames} frames in {wall:.3f} s "
                     f"= {frames / wall:.1f} aggregate frames/s; per round (median) host wall "
                     f"{statistics.median(walls) * 1e3:.2f} ms, LM stream device {ms[0]:.2f} ms, "
                     f"pool codec device {ms[1]:.2f} ms")
        srv.step, sess._decode = lm_step, codec
    same = sum(a == b for a, b in zip(*pcm))
    if same != len(reqs) or not all(pcm[0]):
        fail(f"mesh: serve: {same} of {len(reqs)} requests' PCM equal between the codec "
             f"on the LM's stream and on its own")
    for line in lines:
        print(f"mesh: serve int8 slots=8, {len(reqs)} requests, {line} ({card})", flush=True)
    print(f"mesh: serve: every request's PCM byte-equal with the codec on its own stream "
          f"({same} of {len(reqs)}); launches {json.dumps(PATH_LAUNCHES['vocoder_device'])}",
          flush=True)


def phase_mesh(tts, bundle) -> None:
    """The (dp, tp) mesh on the one card (:func:`mesh_tp` at bf16 and int8,
    :func:`mesh_dp`), with no kernel launched (path "mesh", all five rows
    0), then the serving codec on its own stream (:func:`serve_codec_stream`
    on the int8 instance of phase 5)."""
    import torch

    card = card_line()
    print(f"mesh: a mesh on one card ({card}) exercises the sharding and the reductions, not "
          f"copies between cards: tp=2 and dp=2 over [cuda:0, cuda:0]", flush=True)
    t_phase = time.perf_counter()
    zero_counts()
    mesh_tp(bundle, "bf16", card)
    plain = mesh_tp(bundle, "int8", card)
    mesh_dp(bundle, plain, card)
    del plain
    torch.cuda.synchronize()
    launches = kernel_counts()
    tally("mesh", launches)
    if any(launches.values()):
        fail(f"mesh: kernel launches {launches} on the mesh and plain runs")
    print(f"mesh: kernel launches {json.dumps(launches)}: none on the mesh path", flush=True)
    torch.cuda.empty_cache()
    serve_codec_stream(tts, card, torch.device("cuda", 0))
    print(f"mesh: phase took {time.perf_counter() - t_phase:.1f} s", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="also profile one more synthesize call of the int8 and of the bf16 "
                         "route (their kernel tables go to DIR) and count the sampler's "
                         "rounds on the main path")
    args = ap.parse_args()

    if not (ROOT / "fish_tts_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: the fish_tts_tpu_torch package is not beside this script",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"card: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}", flush=True)

    from fish_tts_tpu_torch.native import bpe
    from fish_tts_tpu_torch.ops import kernels

    t = time.perf_counter()
    so = kernels.build()
    bpe.build_library()
    kernels.lib()
    print(f"build: {so.name} and the BPE encoder in {time.perf_counter() - t:.1f} s",
          flush=True)
    for line in fast_decoder_spills(so.parent / "fast_decoder.cu.log"):
        print(f"build: {line}", flush=True)

    results = phase_kernels(dev)
    phase_ab()
    phase_tools()
    phase_graph(dev)
    launches = phase_main(dev, args.profile)
    launches[HEADLESS] = phase_float(dev, args.profile)
    launches[S8] = PATH_LAUNCHES["ab"][S8]  # the "s8" variant's path: the A/B entry point

    print(f"smoke: {time.perf_counter() - t_start:.1f} s from start to end, the kernels' build "
          f"included", flush=True)
    records = []
    for name, src, replaces in KERNELS:
        row = results[name]["B=1"]
        records.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name],
            "launches_by_path": {path: sums[name] for path, sums in PATH_LAUNCHES.items()},
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
        })
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
