"""Benchmark of the port: decode throughput, RTF and time to first audio, as one JSON line.

The port's counterpart of the repository's one-line ``bench.py``: the same
stages on the same workload, the same flags and defaults, the same keys.
It prints ``#`` lines on stderr and, last on stdout, ONE JSON line::

  {"metric": "semantic_tokens_per_sec", "value": N, "unit": "tok/s",
   "vs_baseline": N/120, ...extras}

It runs the S1-mini-shaped model (random weights: throughput does not depend
on them) in the serving configuration, weight-only int8 with the hand-written
CUDA kernels (``--bf16`` opts out; ``--tiny`` and ``--cpu`` run without
int8), on the card (``--cpu`` for the CPU; without a card it raises: nothing
falls back to the CPU).  The divisor of ``vs_baseline``, 120 tok/s, is the
published figure of the reference Fish-Speech package on torch.compile CUDA
(~120 tok/s, RTF ~0.26), the JAX bench's divisor.

Stages, as in the JAX script:

- decode: a 64-token bucket holding a 48-token prompt
  (``RandomState(0).randint(0, 1000)``), temperature 0.7, top-p 0.8,
  repetition penalty 1.1, ``top_k`` -1 (32 with ``--tiny``), a cache of
  ``cache_bucket(48 + frames + 200)`` rows; after the prefill one warm
  20-frame chunk, then two timed passes of ``frames // 20`` chunks (best
  taken, a re-prefill between them), the KV read window growing in steps of
  256 with the live prefix (``chunk_buckets``).  On the card each chunk is
  a replay of a ``DecodeGraph``, one per KV bucket, as the engine decodes
  (``_timing.Chunks``), timed between CUDA events; on the CPU the eager
  ``decode.decode_chunk`` on the host's clock;
- prefill latency of a fresh state;
- aggregate decode at B = 8 and 16 (``--aggregate-batch``): prompts from
  ``RandomState(1)``, one warm chunk, then 3 timed chunks;
- the user path through ``FishTTS`` with the benchmarked LM parameters (the
  loaded instance with ``--model-dir``): ``ttfa_ms`` (median of 5
  ``synthesize_stream(..., max_tokens=16)`` calls to their first PCM bytes,
  after one warm call), ``vocoder_frames_per_sec`` (320 frames, 3 reps),
  ``rtf_e2e`` (median of 3 ``synthesize`` calls of 200 tokens), LM serving
  (``ContinuousBatcher``, 16 slots, 32 staggered requests of 200 tokens, three
  probes submitted while every slot is busy, 2 passes, best taken) and audio
  serving (``FishTTS.serve(slots=16)``, the same mix, PCM out); with
  ``--model-dir`` also ``audio_rms`` and ``audio_finite``.  These stages
  time the host's wall clock, as a user waits for host bytes.

Each stage's decode states and serving pool are released before the next
(``_timing.free``).  Every stage runs: one that fails raises and the run
exits non-zero (the JAX ``--budget``, which skipped stages once a time had
passed, is not kept).  Keys whose JAX meaning is about XLA report the
first-use cost that takes its place on the card:

- ``compile_s``: the prefill plus the first chunk, with the capture of
  every decode graph the timed passes replay;
- ``init_compile_s``: the kernels' ``nvcc`` build and the BPE encoder's
  ``g++`` build (cached under ``build/``; 0.0 on the CPU);
- ``init_head_s``: 0.0, since the port's slow-stack kernel reads the tied
  head's int8 rows as they are and prepares nothing;
- ``platform_first_op_s``: the first operation on the device (the CUDA
  context);
- ``device``: the card's name and power limit as ``nvidia-smi
  --query-gpu=name,power.limit --format=csv,noheader`` prints them, or
  ``"cpu"``; ``hbm_gb``: ``torch.cuda.memory_allocated`` after the decode
  stage (absent on the CPU, as in the JAX line).

After the line, the port's claims (``fish_tts_tpu_torch/CLAIMS.json``) are
checked against it (``check_claims.check``, 15%) when the line is of the
claims' precision (their ``_precision``): a claim the line no longer backs
prints ``# CLAIMS DRIFT: ...`` on stderr.

Usage: python -m fish_tts_tpu_torch.scripts.bench [--tiny] [--frames N] [--no-ttfa]
       [--cpu] [--bf16] [--approx] [--topk K] [--batch B] [--aggregate-batch B]
       [--model-dir DIR]
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from fish_tts_tpu_torch.config import (
    S1_MINI_CONFIG,
    TINY_CONFIG,
    TINY_VOCODER_CONFIG,
    VocoderConfig,
)
from fish_tts_tpu_torch.engine import decode
from fish_tts_tpu_torch.engine.generate import cache_bucket
from fish_tts_tpu_torch.engine.serve import ContinuousBatcher
from fish_tts_tpu_torch.models import vocoder
from fish_tts_tpu_torch.models.dual_ar import TokenIds, param_count
from fish_tts_tpu_torch.models.tokenizer import (
    FishTokenizer,
    tiny_special_tokens,
    write_tiny_vocab,
)
from fish_tts_tpu_torch.scripts import check_claims
from fish_tts_tpu_torch.scripts._timing import Chunks, device_line, free, lm, resolve_device, timed
from fish_tts_tpu_torch.synthesizer import FishTTS

AUDIO_TOKENS_PER_SEC = 44100 / 2048  # frames per second of audio at the codec's rate
BASELINE_TOK_PER_SEC = 120.0  # the reference package's published CUDA figure
CHUNK = 20  # frames per decode chunk
PROMPT_BUCKET = 64
PROMPT_LEN = 48
KV_STEP = 256  # EngineConfig.kv_bucket_step
SAMPLING = (0.7, 0.8, 1.1)  # temperature, top_p, repetition penalty
# the real tokenizer's id layout (specials after ~151 657 ranks), and the tiny one
S1_IDS = TokenIds(semantic_begin=151672, semantic_end=155767, im_end=151661)
TINY_IDS = TokenIds(semantic_begin=400, semantic_end=447, im_end=5)
SERVE_TEXT = "a serving benchmark request"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def bench_prompt(cfg, batch: int, seed: int = 0) -> np.ndarray:
    """The decode stage's prompts (batch, 1+K, 64): random text ids below
    1000 in row 0, drawn from ``RandomState(seed)``; 48 of them are live."""
    prompt = np.zeros((batch, 1 + cfg.num_codebooks, PROMPT_BUCKET), np.int32)
    prompt[:, 0] = np.random.RandomState(seed).randint(0, 1000, (batch, PROMPT_BUCKET))
    return prompt


def model_prompt(cfg, batch: int, seed: int, dev: torch.device) -> torch.Tensor:
    """``bench_prompt`` on ``dev``, ids past the vocabulary (the tiny
    config's 512) read as its last row, as the JAX embedding gather clamps
    them."""
    return torch.from_numpy(np.minimum(bench_prompt(cfg, batch, seed), cfg.vocab_size - 1)).to(dev)


def state_alloc(cfg, frames: int) -> int:
    """The decode stage's cache rows: the engine's allocation bucket of the
    prompt, the timed frames and the dispatch overshoot."""
    return cache_bucket(PROMPT_LEN + frames + 2 * 100, cfg.max_seq_len)


def chunk_buckets(cfg, n_chunks: int) -> list[int]:
    """The KV read window of each timed chunk: the live prefix after the
    warm chunk and this one, rounded up to KV_STEP, at least the first
    bucket, at most the context."""
    kv_b = min(cfg.max_seq_len, KV_STEP)
    return [max(kv_b, min(cfg.max_seq_len, -(-(PROMPT_LEN + CHUNK * (i + 2)) // KV_STEP) * KV_STEP))
            for i in range(n_chunks)]


def release(dev: torch.device) -> None:
    """Free what the last stage dropped: its states, graphs and pools."""
    gc.collect()
    free(dev)


def main(argv: list[str] | None = None) -> dict:
    """Run the stages, print the JSON line last on stdout and return it."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiny", action="store_true", help="tiny config (CI/CPU)")
    ap.add_argument("--frames", type=int, default=200, help="frames to time")
    ap.add_argument("--no-ttfa", action="store_true", help="skip vocoder/TTFA")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 weights (default is weight-only int8 with the CUDA decode "
                         "kernels, the serving configuration)")
    ap.add_argument("--approx", action="store_true",
                    help="approximate top-k candidate search (opt-in)")
    ap.add_argument("--topk", type=int, default=None,
                    help="top-k truncation for the slow-token sampler")
    ap.add_argument("--batch", type=int, default=1,
                    help="decode N concurrent streams (aggregate tok/s)")
    ap.add_argument("--aggregate-batch", type=int, default=8,
                    help="also measure aggregate throughput at this batch size (0 to skip; "
                         "only when --batch is 1)")
    ap.add_argument("--model-dir", default=None,
                    help="checkpoint dir: throughput AND fidelity on its weights (audio RMS "
                         "lands in the JSON); default is random weights (throughput only)")
    args = ap.parse_args(argv)
    # int8 with the kernels is the serving configuration and the default
    args.int8 = not args.bf16 and not args.tiny and not args.cpu
    dev = resolve_device("cpu" if args.cpu else "cuda")

    if args.tiny:
        cfg, ids, dtype, vcfg = TINY_CONFIG, TINY_IDS, torch.float32, TINY_VOCODER_CONFIG
    else:
        cfg, ids, dtype, vcfg = S1_MINI_CONFIG, S1_IDS, torch.bfloat16, VocoderConfig()
    card = device_line(dev)
    log(f"# device: {card}, config: dim={cfg.dim} layers={cfg.n_layer} "
        f"fast={cfg.n_fast_layer} vocab={cfg.vocab_size} "
        f"precision={'int8' if args.int8 else str(dtype).removeprefix('torch.')}")

    # the first operation on the device pays for its context
    t0 = time.perf_counter()
    (torch.zeros((8,), device=dev) + 1.0).cpu()
    first_op_s = time.perf_counter() - t0
    log(f"# platform first-op: {first_op_s:.1f}s")

    # the kernels' and the BPE encoder's builds are the card's compile step
    t0 = time.perf_counter()
    if dev.type == "cuda":
        from fish_tts_tpu_torch.native import bpe
        from fish_tts_tpu_torch.ops import kernels

        kernels.lib()
        bpe.build_library()
    init_compile_s = time.perf_counter() - t0

    real_tts = None
    t0 = time.perf_counter()
    if args.model_dir:
        # the checkpoint's load (convert, cast, quantize) is the init measured; its
        # engine parameters feed every stage, so speed and fidelity share them
        init_build_s = init_head_s = None
        real_tts = FishTTS(model_dir=args.model_dir, device=dev.type,
                           precision="int8" if args.int8 else "bf16", warmup=False)
        cfg = real_tts._cfg
        tk = real_tts._tokenizer
        ids = TokenIds(semantic_begin=tk.semantic_begin_id, semantic_end=tk.semantic_end_id,
                       im_end=tk.im_end_id)
        params, rope = real_tts.engine.params, real_tts.engine.rope
        sync(dev)
        init_materialize_s = time.perf_counter() - t0
    else:
        cfg, params, rope = lm(args.tiny, dev, args.int8)
        sync(dev)
        init_build_s = time.perf_counter() - t0
        init_head_s = 0.0
        init_materialize_s = init_build_s + init_head_s
        log(f"# init materialize: build {init_build_s:.1f}s + head prep {init_head_s:.1f}s")
    init_s = init_compile_s + init_materialize_s
    n_params = param_count({k: v for k, v in params.items() if not k.startswith("_")})
    log(f"# init: {init_s:.1f}s = compile {init_compile_s:.1f}s + materialize "
        f"{init_materialize_s:.1f}s ({n_params / 1e6:.0f}M params)")

    top_k = args.topk if args.topk is not None else (-1 if not args.tiny else 32)
    if args.approx and top_k <= 0:
        top_k = 1024  # approx applies only to a truncated candidate search
    opts = dict(top_k=top_k, approx=args.approx)
    B = max(1, args.batch)
    prompt = model_prompt(cfg, B, 0, dev)
    lengths = torch.full((B,), PROMPT_LEN, dtype=torch.int32, device=dev)

    def prefill(state, seed: int, prompt=prompt, lengths=lengths):
        decode.prefill(params, rope, state, prompt, lengths, decode.GumbelNoise(seed, cfg),
                       *SAMPLING, cfg=cfg, ids=ids, kv_bucket=0, **opts)

    # -- first use: prefill, every decode graph's capture, one warm chunk ----------
    alloc = state_alloc(cfg, args.frames)
    n_chunks = max(1, args.frames // CHUNK)
    buckets = chunk_buckets(cfg, n_chunks)
    kv_b = min(cfg.max_seq_len, KV_STEP)
    t0 = time.perf_counter()
    state = decode.init_state(params, cfg, batch=B, max_seq_len=alloc)
    prefill(state, 1)
    chunks = {kv: Chunks(params, cfg, ids, rope, state, frames=CHUNK, kv_bucket=kv,
                         skip_done=B > 1, **opts) for kv in sorted({kv_b, *buckets})}
    chunks[kv_b]()
    sync(dev)
    compile_s = time.perf_counter() - t0
    log(f"# prefill+chunk first use (graph captures included): {compile_s:.1f}s")

    # -- throughput: two passes, best taken, the KV window growing -------------------
    def one_pass():
        for kv in buckets:
            chunks[kv]()

    pass_times = []
    for rep in range(2):
        pass_times.append(timed(one_pass, dev)[0])
        if rep == 0:
            # restart positions so pass 2 matches pass 1; the graphs hold the state
            decode.reset_state(state)
            prefill(state, 1)
            sync(dev)
    dt = min(pass_times)
    n_frames = n_chunks * CHUNK
    tok_per_sec = n_frames * B / dt  # aggregate across concurrent streams
    rtf = (dt / n_frames) * AUDIO_TOKENS_PER_SEC
    log(f"# decode: {tok_per_sec:.1f} tok/s, RTF={rtf:.4f} "
        f"(passes: {[round(n_frames * B / x, 1) for x in pass_times]})")

    # -- prefill latency -------------------------------------------------------------
    def fresh_prefill():
        prefill(decode.init_state(params, cfg, batch=B, max_seq_len=alloc), 9)

    prefill_ms = timed(fresh_prefill, dev)[0] * 1e3

    extras = {
        "rtf": round(rtf, 4),
        "batch": B,
        "prefill_ms": round(prefill_ms, 1),
        "frames_timed": n_frames,
        "compile_s": round(compile_s, 1),
        "init_s": round(init_s, 1),
        "init_compile_s": round(init_compile_s, 1),
        "init_materialize_s": round(init_materialize_s, 1),
        "platform_first_op_s": round(first_op_s, 1),
        **({"init_build_s": round(init_build_s, 1), "init_head_s": round(init_head_s, 1)}
           if init_build_s is not None else {}),
        "precision": "int8" if args.int8 else ("fp32" if args.tiny else "bf16"),
        "device": card,
    }
    if dev.type == "cuda":
        extras["hbm_gb"] = round(torch.cuda.memory_allocated(dev) / 2**30, 2)
    del chunks, state
    release(dev)

    # -- aggregate throughput of batched decode --------------------------------------
    if B == 1 and args.aggregate_batch > 1 and not args.tiny:
        batches = ({args.aggregate_batch, 16} if args.aggregate_batch == 8
                   else {args.aggregate_batch})
        for Ba in sorted(batches):
            state_a = decode.init_state(params, cfg, batch=Ba,
                                        max_seq_len=cache_bucket(PROMPT_LEN + CHUNK * 5,
                                                                  cfg.max_seq_len))
            prefill(state_a, 11, prompt=model_prompt(cfg, Ba, 1, dev),
                    lengths=torch.full((Ba,), PROMPT_LEN, dtype=torch.int32, device=dev))
            chunks_a = Chunks(params, cfg, ids, rope, state_a, frames=CHUNK, kv_bucket=kv_b,
                              skip_done=True, **opts)
            chunks_a()  # warm
            reps_a = 3
            secs = timed(lambda: [chunks_a() for _ in range(reps_a)], dev)[0]
            agg = CHUNK * reps_a * Ba / secs
            extras[f"aggregate_tok_per_sec_b{Ba}"] = round(agg, 1)
            log(f"# batched serving: {agg:.0f} tok/s aggregate at B={Ba}")
            del chunks_a, state_a
            release(dev)

    # -- TTFA and end-to-end RTF through the public path -----------------------------
    if not args.no_ttfa:
        extras.update(measure_user_path(args, cfg, vcfg, params, dtype, dev, real_tts))

    result = {
        "metric": "semantic_tokens_per_sec",
        "value": round(tok_per_sec, 1),
        "unit": "tok/s",
        "vs_baseline": round(tok_per_sec / BASELINE_TOK_PER_SEC, 2),
        **extras,
    }
    print(json.dumps(result), flush=True)

    # epilogue: flag published claims that this run no longer backs
    if not args.tiny:
        drift = claims_drift(result)
        if drift is None:
            log("# claims not checked: none, or of another precision than this line")
        for d in drift or []:
            log(f"# CLAIMS DRIFT: {d}")
    return result


def claims_drift(line: dict) -> list[str] | None:
    """The port's claims that ``line`` no longer backs (15%); None without
    a claims file or when the claims are of another precision (their
    ``_precision``) than the line."""
    if not check_claims.CLAIMS.exists():
        return None
    claims = json.loads(check_claims.CLAIMS.read_text())
    if claims.get("_precision", line["precision"]) != line["precision"]:
        return None
    return check_claims.check(claims, line, 0.15)


def user_path_instance(args, cfg, vcfg, params, dtype, dev: torch.device):
    """A ``FishTTS`` on the benchmarked LM parameters, a full-size codec with
    random weights (seed 7) and a byte-level tokenizer with the config's
    semantic range."""
    with tempfile.TemporaryDirectory(prefix="fish_tts_bench_") as d:
        write_tiny_vocab(Path(d) / "tokenizer.tiktoken")
        tokenizer = FishTokenizer(Path(d) / "tokenizer.tiktoken",
                                  tiny_special_tokens(cfg.codebook_size))
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    vparams = vocoder.init_vocoder_params(gen, vcfg, dtype=dtype)
    sync(dev)
    log(f"# vocoder init: {time.perf_counter() - t0:.1f}s")
    return FishTTS(device=dev.type, precision="fp32" if args.tiny else "bf16", warmup=False,
                   _testing_bundle=(cfg, params, tokenizer, vcfg, vparams))


def measure_user_path(args, cfg, vcfg, params, dtype, dev: torch.device,
                      real_tts=None) -> dict:
    """User-path numbers through the public ``FishTTS`` API:

    - ``ttfa_ms``: median time from ``synthesize_stream(text)`` to its first
      PCM bytes on the host;
    - ``vocoder_frames_per_sec``: the codec's decode alone;
    - ``rtf_e2e``: a whole ``synthesize()`` call's wall time over the seconds
      of audio it made (the top-level ``rtf`` is LM decode only);
    - the LM and the audio serving stages (``measure_serving``);
    - with ``--model-dir``, the e2e audio's RMS and whether it is finite.

    The LM parameters are the benchmarked ones; with ``--model-dir`` the
    whole stack (tokenizer, codec, weights) is the checkpoint's."""
    if real_tts is not None:
        tts = real_tts
        vcfg = real_tts._vocoder_cfg  # the code geometry of the loaded codec
    else:
        tts = user_path_instance(args, cfg, vcfg, params, dtype, dev)

    text = "Benchmark time to first audio."

    def first_chunk_latency() -> float:
        t0 = time.perf_counter()
        stream = tts.synthesize_stream(text, max_tokens=16)
        chunk = next(iter(stream))
        dt = time.perf_counter() - t0
        stream.close()
        if not chunk:
            raise RuntimeError("synthesize_stream: an empty first chunk")
        return dt

    warm = first_chunk_latency()  # first use: graph captures, codec shapes
    log(f"# ttfa first use+run: {warm:.1f}s")
    lat = sorted(first_chunk_latency() for _ in range(5))
    out = {"ttfa_ms": round(lat[len(lat) // 2] * 1e3, 1), "ttfa_max_ms": round(lat[-1] * 1e3, 1)}

    # -- the codec alone ---------------------------------------------------------------
    frames = 320 if not args.tiny else 20
    codes = np.random.RandomState(0).randint(
        0, vcfg.residual_codebook_size, (vcfg.num_codebooks, frames)).astype(np.int64)
    tts._decode_codes(codes)  # first use
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        tts._decode_codes(codes)
    voc_fps = frames * reps / (time.perf_counter() - t0)
    out["vocoder_frames_per_sec"] = round(voc_fps, 1)
    log(f"# vocoder: {voc_fps:.0f} frames/s (RTF {AUDIO_TOKENS_PER_SEC / voc_fps:.4f})")

    # -- end-to-end RTF: a whole synthesize() over its audio seconds -------------------
    if args.tiny:
        n_tok, text = 16, "Hello."  # byte-level tiny tokenizer, 128-token context
    else:
        n_tok = 200
        text = "An end to end benchmark sentence for real time factor measurement."
    tts.synthesize(text, max_tokens=n_tok)  # first use
    rtfs = []
    for _ in range(3):
        t0 = time.perf_counter()
        wav = tts.synthesize(text, max_tokens=n_tok)
        wall = time.perf_counter() - t0
        audio_sec = (len(wav) - 44) / 2 / tts.sample_rate  # 16-bit mono WAV
        rtfs.append(wall / audio_sec)
    rtfs.sort()
    out["rtf_e2e"] = round(rtfs[1], 4)
    log(f"# e2e: {audio_sec:.2f}s audio, RTF p50 {rtfs[1]:.4f} "
        f"(runs {[round(r, 4) for r in rtfs]})")

    # -- continuous batching: the LM pool, then the audio pool --------------------------
    out.update(measure_serving(tts, tiny=args.tiny, audio=False))
    release(dev)
    out.update(measure_serving(tts, tiny=args.tiny, audio=True))
    release(dev)
    if real_tts is not None:
        # fidelity on the checkpoint's weights: audio that is not silent and finite
        pcm = np.frombuffer(wav[44:], dtype=np.int16).astype(np.float32) / 32767.0
        rms = float(np.sqrt(np.mean(pcm**2))) if pcm.size else 0.0
        out["audio_rms"] = round(rms, 4)
        out["audio_finite"] = bool(np.isfinite(pcm).all())
        log(f"# fidelity: rms={rms:.4f} finite={out['audio_finite']}")
    return out


def serving_mix(tiny: bool) -> tuple[int, int, int, set[int]]:
    """(slots, requests, frames per request, the pending counts at which a
    refill is a busy probe): 16 slots and 32 staggered requests of 200
    frames (4, 8 and 16 with ``--tiny``); the probes are submitted mid-pass,
    while every slot is busy."""
    slots = 4 if tiny else 16
    n_req = 2 * slots
    return slots, n_req, 16 if tiny else 200, {n_req // 2, n_req // 2 - 1, n_req // 2 + 1}


# a serving pass: wall seconds, summed event counts, sorted busy-probe latencies
Pass = tuple[float, np.ndarray, list[float]]


def staggered_passes(sess, tiny: bool, first_output, count) -> list[Pass]:
    """Two passes of the serving mix through ``sess`` (a ``ContinuousBatcher``
    or a ``FishTTS.serve`` session), after a warm pass: the first wave fills
    every slot, each finished request's slot is refilled while requests are
    pending, and the refills at ``probe_at`` are the busy probes.  Per pass:
    its wall time, the sum of ``count(event)`` over its events, and each
    probe's time from its submit to its first event for which
    ``first_output(event)`` holds."""
    slots, n_req, budget, probe_at = serving_mix(tiny)
    for _ in range(2):  # first use of the admission, pool-decode and pool-codec shapes
        sess.submit("warm up the pool", max_new_tokens=4 if tiny else 24)
    for _ in sess.run():
        pass

    def one_pass() -> Pass:
        t0 = time.perf_counter()
        pending = n_req
        total = 0
        probe_submit: dict[int, float] = {}
        probe_first: list[float] = []
        for _ in range(slots):  # first wave
            sess.submit(SERVE_TEXT, max_new_tokens=budget)
            pending -= 1
        while sess.busy or pending:
            for ev in sess.step():
                if ev.request_id in probe_submit and first_output(ev):
                    probe_first.append(time.perf_counter() - probe_submit.pop(ev.request_id))
                total = total + count(ev)
                if ev.done and pending:  # staggered: refill as slots free
                    rid = sess.submit(SERVE_TEXT, max_new_tokens=budget)
                    if pending in probe_at:
                        probe_submit[rid] = time.perf_counter()
                    pending -= 1
        return time.perf_counter() - t0, total, sorted(probe_first)

    return [one_pass() for _ in range(2)]


def measure_serving(tts, tiny: bool, audio: bool) -> dict:
    """Serving throughput over the staggered mix, best of two passes, with
    the time from a busy probe's submit to its first output.  LM serving
    (``audio`` False): the ``ContinuousBatcher`` slot pool, frames emitted
    per wall-clock second across all requests, a probe's first codes.  Audio
    serving: ``FishTTS.serve`` (the LM pool plus the slot-pool stateful
    codec, PCM out), finished requests' frames per second and the seconds
    of PCM per second, a probe's first PCM."""
    slots, n_req, budget, _ = serving_mix(tiny)
    if audio:
        results = staggered_passes(
            tts.serve(slots=slots), tiny, lambda ev: len(ev.pcm) > 0,
            lambda ev: np.array([ev.frames_total if ev.done else 0, len(ev.pcm)]))
        key, busy, what = "serve_audio", ["ttfa_audio_busy_ms"], "audio serving"
    else:
        results = staggered_passes(ContinuousBatcher(tts.engine, slots=slots), tiny,
                                   lambda ev: ev.codes.shape[1] > 0,
                                   lambda ev: np.array([ev.codes.shape[1]]))
        key, busy, what = "serve", ["ttfa_busy_ms", "ttfa_busy_max_ms"], "continuous batching"
    rates = [float(total[0]) / wall for wall, total, _ in results]
    best = int(np.argmax(rates))
    wall, total, probe_first = results[best]
    out = {f"{key}_tok_per_sec": round(rates[best], 1)}
    if audio:
        out["serve_audio_x_realtime"] = round(float(total[1]) / 2 / tts.sample_rate / wall, 1)
    else:
        out["serve_slots"] = slots
    out[f"{key}_passes"] = [round(r, 1) for r in rates]
    if probe_first:
        # the median, then (LM serving) the worst
        out.update(zip(busy, (round(probe_first[len(probe_first) // 2] * 1e3, 1),
                              round(probe_first[-1] * 1e3, 1))))
    log(f"# {what}: {rates[best]:.0f} tok/s aggregate ({n_req} staggered requests x {budget} "
        f"tok over {slots} slots), busy-TTFA p50 {out.get(busy[0], 'n/a')} ms "
        f"(passes: {out[f'{key}_passes']})")
    return out


if __name__ == "__main__":
    main()
