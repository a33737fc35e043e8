"""The port's one-line bench (``fish_tts_tpu_torch/scripts/bench.py``) on the
CPU at tiny size, held against the JAX ``bench.py``:

- the JAX script's line at ``--tiny --cpu --frames 20 --no-ttfa`` (run once
  in a subprocess, beside the port's runs) has exactly the keys of the
  port's decode stage at the same flags;
- the port's full ``--tiny --cpu --frames 20`` line has exactly those keys
  and the user path's (written out below from ``bench.py:545-810``: a full
  tiny JAX run takes ~50 s); with ``--model-dir`` it adds ``audio_rms`` and
  ``audio_finite``, as the JAX line does, and drops the init sub-stages;
- the decode workload is the JAX one: the prompts, the live lengths, the
  cache allocation (against the JAX ``_cache_bucket``) and the KV bucket of
  each chunk, at the tiny config (spied on a run) and at S1-mini widths;
- ``rtf`` x ``value`` is 44 100 / 2048 x ``batch`` within the rounding of
  the two;
- ``--topk`` and ``--approx`` give the sampler the JAX script's options,
  and a run with both times its decode stage;
- without ``--cpu`` and without a card it raises;
- a serving stage that raises makes ``main`` raise, with no line printed
  (the JAX script wrote ``serve_failed`` instead);
- the smoke's check of the line on the card (``chip_smoke.check_bench``)
  passes the line it is built for and fails on a missing or a fallback key,
  a number that is not finite and positive, and an ``rtf`` that does not
  match ``value``; its check of one bench run's launches passes the three
  kernels at int8 and the sampler alone at bf16, and fails on any other.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_stream import one_thread  # noqa: F401 (an autouse fixture)

import chip_smoke
from fish_tts_tpu.engine.generate import _cache_bucket as jax_cache_bucket
from fish_tts_tpu_torch import FishTTS, testing
from fish_tts_tpu_torch.config import S1_MINI_CONFIG, TINY_CONFIG
from fish_tts_tpu_torch.engine import serve as serve_mod
from fish_tts_tpu_torch.scripts import bench
from fish_tts_tpu_torch.utils.audio import to_wav_bytes

ROOT = Path(__file__).resolve().parent.parent
TINY = ["--tiny", "--cpu", "--frames", "20"]
# The user path's keys at --tiny without --model-dir: bench.py:619 (TTFA),
# :632 (codec), :651 (e2e), :738-744 (LM serving), :802-808 (audio serving).
USER_KEYS = {
    "ttfa_ms", "ttfa_max_ms", "vocoder_frames_per_sec", "rtf_e2e", "serve_tok_per_sec",
    "serve_slots", "serve_passes", "ttfa_busy_ms", "ttfa_busy_max_ms",
    "serve_audio_tok_per_sec", "serve_audio_x_realtime", "serve_audio_passes",
    "ttfa_audio_busy_ms"}
FIDELITY_KEYS = {"audio_rms", "audio_finite"}  # bench.py:676-677, with --model-dir
INIT_SUB_KEYS = {"init_build_s", "init_head_s"}  # bench.py:436-438, not with --model-dir


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX bench at ``--tiny --cpu --frames 20 --no-ttfa``, started in a
    subprocess when the module's first test asks for it; ``wait()`` gives
    its JSON line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               FISH_TTS_TPU_CACHE_DIR=str(tmp_path_factory.mktemp("xla_cache")))
    proc = subprocess.Popen([sys.executable, "bench.py", *TINY, "--no-ttfa"], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    class Run:
        def wait(self) -> dict:
            out, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, err[-2000:]
            return json.loads(out.strip().splitlines()[-1])

    yield Run()
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def port_line(jax_run):
    """The port's full tiny line (the JAX run goes on beside it)."""
    return bench.main(TINY)


def product_ok(line: dict) -> bool:
    """``rtf`` x ``value`` = 44 100 / 2048 x ``batch`` within the rounding of
    ``rtf`` to 4 decimals and ``value`` to 1."""
    err = abs(line["rtf"] * line["value"] - 44100 / 2048 * line["batch"])
    return err <= 5e-5 * line["value"] + 0.05 * line["rtf"] + 1e-9


def test_full_line_has_the_decode_and_user_path_keys(port_line, capsys):
    decode_keys = chip_smoke.BENCH_DECODE_KEYS - {"hbm_gb"}  # the CPU has no hbm_gb
    assert set(port_line) == decode_keys | USER_KEYS == (decode_keys | chip_smoke.BENCH_USER_KEYS)
    assert port_line["precision"] == "fp32" and port_line["device"] == "cpu"
    assert port_line["frames_timed"] == 20 and port_line["serve_slots"] == 4
    for key, v in port_line.items():
        if isinstance(v, (int, float)):
            assert math.isfinite(v) and v >= 0, key
    assert product_ok(port_line)


def test_decode_workload_is_the_jax_one(monkeypatch):
    """Spied on a tiny run: the prompt, lengths and cache allocation of every
    prefill and the KV bucket of every chunk call; at S1-mini widths, the
    allocation and the buckets of 200 timed frames."""
    prefills, chunk_calls = [], []
    real_prefill, real_chunks = bench.decode.prefill, bench.Chunks

    def spy_prefill(params, rope, state, prompt, lengths, *a, **k):
        prefills.append((prompt.numpy().copy(), lengths.numpy().copy(),
                         state["kv"]["k"].shape[3], prompt.shape[0]))
        return real_prefill(params, rope, state, prompt, lengths, *a, **k)

    class SpyChunks(real_chunks):
        def __call__(self):
            chunk_calls.append(self.kv_bucket)
            return super().__call__()

    monkeypatch.setattr(bench.decode, "prefill", spy_prefill)
    monkeypatch.setattr(bench, "Chunks", SpyChunks)
    bench.main([*TINY, "--no-ttfa"])

    # bench.py:295-299: the 64-token bucket, RandomState(0) ids below 1000, 48 live
    want = np.zeros((1, 1 + TINY_CONFIG.num_codebooks, 64), np.int32)
    want[:, 0] = np.random.RandomState(0).randint(0, 1000, (1, 64))
    np.testing.assert_array_equal(bench.bench_prompt(TINY_CONFIG, 1), want)
    # the tiny vocabulary's 512 rows: the JAX gather clamps the larger ids
    alloc = jax_cache_bucket(48 + 20 + 2 * 100, TINY_CONFIG.max_seq_len)  # bench.py:313
    assert len(prefills) == 3  # the first use, the re-prefill of pass 2, the latency
    for prompt, lengths, rows, batch in prefills:
        np.testing.assert_array_equal(prompt, np.minimum(want, TINY_CONFIG.vocab_size - 1))
        np.testing.assert_array_equal(lengths, [48])
        assert (rows, batch) == (alloc, 1)
    # bench.py:324, :386-393: a warm chunk at min(ctx, 256), then each pass's chunks
    kv = min(TINY_CONFIG.max_seq_len, 256)
    assert chunk_calls == [kv, kv, kv]

    # at S1-mini widths, --frames 200: the JAX formulas
    cfg = S1_MINI_CONFIG
    assert bench.state_alloc(cfg, 200) == jax_cache_bucket(48 + 200 + 2 * 100, cfg.max_seq_len)
    want_kv = [max(min(cfg.max_seq_len, 256),
                   min(cfg.max_seq_len, -(-(48 + 20 * (i + 2)) // 256) * 256)) for i in range(10)]
    assert bench.chunk_buckets(cfg, 10) == want_kv == [256] * 9 + [512]
    # bench.py:466-467, :472: the aggregate prompts and allocation
    agg = np.zeros((8, 1 + cfg.num_codebooks, 64), np.int32)
    agg[:, 0] = np.random.RandomState(1).randint(0, 1000, (8, 64))
    np.testing.assert_array_equal(bench.bench_prompt(cfg, 8, seed=1), agg)
    assert jax_cache_bucket(48 + 20 * 5, cfg.max_seq_len) == bench.cache_bucket(
        bench.PROMPT_LEN + bench.CHUNK * 5, cfg.max_seq_len)


class Stop(Exception):
    pass


@pytest.mark.parametrize("flags, top_k, approx", [
    ((), 32, False), (("--topk", "8"), 8, False), (("--approx",), 32, True),
    (("--topk", "-1", "--approx"), 1024, True)])
def test_topk_and_approx_reach_the_sampler(monkeypatch, flags, top_k, approx):
    """bench.py:301-303: ``--topk`` (default -1, 32 with ``--tiny``), and
    ``--approx`` widening an untruncated search to 1024 candidates; the
    prefill's options are the ones every chunk is given."""
    seen = {}

    def spy_prefill(*a, top_k, approx, **k):
        seen.update(top_k=top_k, approx=approx)
        raise Stop

    monkeypatch.setattr(bench.decode, "prefill", spy_prefill)
    with pytest.raises(Stop):
        bench.main([*TINY, "--no-ttfa", *flags])
    assert seen == dict(top_k=top_k, approx=approx)


def test_topk_and_approx_run_the_decode_stage():
    line = bench.main([*TINY, "--no-ttfa", "--topk", "8", "--approx"])
    assert line["frames_timed"] == 20 and product_ok(line)


def test_batch_line_rtf_times_value(capsys):
    line = bench.main([*TINY, "--no-ttfa", "--batch", "2"])
    assert line["batch"] == 2 and product_ok(line)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == line


def test_without_a_card_it_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        bench.main(["--tiny"])


def test_a_failing_serving_stage_raises(monkeypatch, capsys):
    """The stages before serving answer at once (a frame of silence), so the
    run reaches the LM serving stage, whose rounds raise."""
    frame = np.zeros(TINY_CONFIG.num_codebooks, np.float32)
    monkeypatch.setattr(FishTTS, "synthesize_stream",
                        lambda self, text, **kw: (pcm for pcm in [b"\0\0"]))
    monkeypatch.setattr(FishTTS, "synthesize",
                        lambda self, text, **kw: to_wav_bytes(frame, self.sample_rate))

    def boom(self):
        raise RuntimeError("serving round failed")

    monkeypatch.setattr(serve_mod.ContinuousBatcher, "step", boom)
    with pytest.raises(RuntimeError, match="serving round failed"):
        bench.main(TINY)
    assert capsys.readouterr().out == ""  # no line, so no *_failed key


def test_model_dir_adds_the_fidelity_keys(tmp_path):
    d = testing.write_reference_dir(tmp_path / "ckpt", testing.make_tiny_bundle(0))
    line = bench.main([*TINY, "--model-dir", str(d)])
    decode_keys = chip_smoke.BENCH_DECODE_KEYS - {"hbm_gb"} - INIT_SUB_KEYS
    assert set(line) == decode_keys | USER_KEYS | FIDELITY_KEYS
    assert line["precision"] == "fp32"  # the JAX label of a tiny run
    assert line["audio_finite"] is True
    assert math.isfinite(line["audio_rms"]) and line["audio_rms"] >= 0


def test_smoke_check_bench(port_line, monkeypatch):
    """``chip_smoke.check_bench`` on the full line as the card gives it."""
    monkeypatch.setattr(chip_smoke, "card_line", lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    good = dict(port_line, precision="int8", serve_slots=16, device=chip_smoke.card_line(),
                hbm_gb=1.5, aggregate_tok_per_sec_b8=900.0, aggregate_tok_per_sec_b16=1500.0)
    frames = bench.CHUNK * 10
    good["frames_timed"] = frames
    assert "rtf_e2e" in chip_smoke.check_bench(good, ())
    bad = [({k: v for k, v in good.items() if k != "ttfa_busy_ms"}, "missing keys"),
           (dict(good, kernel_fallback=True), "extra keys"),
           (dict(good, ttfa_ms=float("nan")), "ttfa_ms"),
           (dict(good, serve_passes=[10.0, 0.0]), "serve_passes"),
           (dict(good, rtf=round(good["rtf"] * 1.01, 4)), "rtf"),
           (dict(good, serve_slots=4), "serve_slots"),
           (dict(good, frames_timed=20), "frames_timed"),
           (dict(good, precision="bf16"), "precision")]
    for line, what in bad:
        with pytest.raises(SystemExit, match=what):
            chip_smoke.check_bench(line, ())
    decode_only = {k: good[k] for k in chip_smoke.BENCH_DECODE_KEYS}
    argv = ("--bf16", "--no-ttfa", "--aggregate-batch", "0")
    assert "prefill_ms" in chip_smoke.check_bench(dict(decode_only, precision="bf16"), argv)


def test_jax_decode_keys_equal_the_port_decode_keys(jax_run):
    """Last, so the JAX run has gone on beside the port's runs."""
    port = bench.main([*TINY, "--no-ttfa"])
    jax = jax_run.wait()
    assert set(jax) == set(port)
    for key in ("metric", "unit", "batch", "frames_timed", "precision"):
        assert jax[key] == port[key], key


ROUTE = {"sample_slow": 30, "slow_stack_step": 20, chip_smoke.HEADLESS: 0,
         "fast_decode_frame": 20, chip_smoke.S8: 0}


@pytest.mark.parametrize("added, argv, ok", [
    (ROUTE, (), True),
    (dict(ROUTE, slow_stack_step=0, fast_decode_frame=0), ("--bf16",), True),
    (dict(ROUTE, fast_decode_frame=0), (), False),  # a plain route inside the int8 run
    (dict(ROUTE, **{chip_smoke.S8: 20, "fast_decode_frame": 0}), (), False),
    (dict(ROUTE, slow_stack_step=0), ("--bf16",), False),  # int8 kernels in the bf16 run
    (dict(ROUTE, sample_slow=0, slow_stack_step=0, fast_decode_frame=0), ("--bf16",), False)])
def test_smoke_check_bench_launches(added, argv, ok):
    """``chip_smoke.check_bench_launches`` on one bench run's launches: each
    of the three kernels at int8, the sampler alone at bf16."""
    if ok:
        chip_smoke.check_bench_launches(added, argv)
    else:
        with pytest.raises(SystemExit, match="kernel launches"):
            chip_smoke.check_bench_launches(added, argv)
