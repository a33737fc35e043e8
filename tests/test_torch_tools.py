"""The port's measurement scripts (``fish_tts_tpu_torch/scripts/``) on the CPU
at tiny size, against the JAX scripts they port:

- every profiler's rows are finite and carry the JAX script's labels, with
  "XLA" renamed "plain route" and "Pallas kernels" renamed "kernels";
- the benchmark's JSON has the JAX ``Report``'s keys (plus ``device`` and
  ``peak_memory_gb``), its ``WORKLOADS`` are the JAX script's, and each
  row's audio is its frames x frame_length / 44 100; the smoke's report
  check passes on it;
- the sampler check exits 0 at the full S1-mini width (both sides plain on
  the CPU) and 1 when the plain sampler flips one row;
- the kernel-gate A/B runs each row on the route with exactly that part
  off (a spy on ``decode.route``) and restores every ``supports``, after a
  normal return and after an exception;
- the KV-bucket A/B skips an out-of-contract bucket and runs the others;
- the serving profiler's wrapped attributes are restored and its phases
  carry the JAX labels;
- ``--device cuda`` without a card raises, in every script.

The JAX scripts run only on a TPU (their kernels have no CPU lowering), so
their labels are written out here.
"""

import importlib.util
import json
import math
import sys
from pathlib import Path

import pytest
import torch
from test_torch_stream import one_thread  # noqa: F401 (an autouse fixture)

import chip_smoke
from fish_tts_tpu_torch import FishTTS, testing
from fish_tts_tpu_torch.config import TINY_VOCODER_CONFIG
from fish_tts_tpu_torch.engine import decode
from fish_tts_tpu_torch.engine import serve as serve_mod
from fish_tts_tpu_torch.ops import fast_decoder, sampler_kernel, slow_stack
from fish_tts_tpu_torch.scripts import (
    _timing,
    ab_kernel_gates,
    ab_kvbucket,
    benchmark,
    profile_batch,
    profile_decode,
    profile_serving,
    profile_slow_parts,
    profile_vocoder,
    verify_sampler,
)

ROOT = Path(__file__).resolve().parent.parent
TINY = ["--tiny", "--device", "cpu"]
# The port's renames of the JAX scripts' row labels.
RENAMES = {"(XLA paths)": "(plain route)", "(XLA)": "(plain route)",
           "(Pallas kernels)": "(kernels)", "(scan over layers)": "(loop over layers)",
           "(B x dyn_upd_slice)": "(B x row copy)"}
JAX_LABELS = {
    "profile_decode": ["decode chunk (XLA paths)", "slow sampling (top_k=32)"],
    "profile_batch": ["decode chunk (XLA)", "decode chunk (kernels)", "slow stack alone (XLA)",
                      "LM head alone (XLA)", "fast codebook loop alone (XLA)",
                      "slow sampling alone (top_p thresh)", "slow kernel + head + scatter",
                      "fast kernel (codebook loop)", "sampler kernel (fused top-p)"],
    "profile_slow_parts": ["matmul chain only (scan over layers)",
                           "attention only (R-slice, no scatter)",
                           "cache scatter only (advanced idx)",
                           "cache scatter only (B x dyn_upd_slice)", "full slow_forward (XLA)"],
}
SERVE_LABELS = {"lm_step", "lm_dispatch", "lm_frames_fetch+route", "voc_dispatch",
                "audio_fetch+convert"}


def renamed(label: str) -> str:
    for old, new in RENAMES.items():
        label = label.replace(old, new)
    return label


def check_finite(records) -> None:
    for rec in records:
        if rec.get("derived"):
            continue
        values = [rec[k] for k in ("value", "host_s", "frames_per_s") if k in rec]
        assert values and all(math.isfinite(v) and v > 0 for v in values), rec
        assert rec["device"] == "cpu" and rec["clock"] == "host clock", rec


@pytest.mark.parametrize("name, mod, argv", [
    ("profile_decode", profile_decode, ["-n", "1"]),
    ("profile_batch", profile_batch, ["-n", "1", "-b", "4", "--kernels"]),
    ("profile_slow_parts", profile_slow_parts, ["-n", "1", "-b", "4"]),
])
def test_profiler_rows_carry_the_jax_labels(name, mod, argv):
    records = mod.main(TINY + argv)
    check_finite(records)
    assert [r["label"] for r in records] == [renamed(x) for x in JAX_LABELS[name]]
    assert all(r["unit"] == "ms/frame" for r in records)


def test_profile_vocoder_rows():
    records = profile_vocoder.main(TINY + ["-n", "1", "-b", "2", "-f", "4"])
    check_finite(records)
    labels = [r["label"] for r in records]
    assert labels[:2] == ["dac_decode (full pool chunk)", "decoder_forward (conv stack)"]
    assert labels[-1] == "totals"
    stages = labels[2:-1]
    # per decoder block: its snake and up-conv, then per unit a snake and two convs
    n_blocks = len(TINY_VOCODER_CONFIG.decoder_rates)
    assert len(stages) == n_blocks * (2 + 3 * 3) + 2
    tot = records[-1]
    assert tot["snake_ms"] > 0 and tot["conv_ms"] > 0 and tot["up_ms"] > 0


def _jax_benchmark():
    spec = importlib.util.spec_from_file_location("jax_benchmark_script",
                                                  ROOT / "scripts" / "benchmark.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["jax_benchmark_script"] = mod  # dataclass fields resolve by module name
    spec.loader.exec_module(mod)
    return mod


def test_benchmark_report_matches_the_jax_report(capsys):
    jax_bench = _jax_benchmark()
    assert benchmark.WORKLOADS == jax_bench.WORKLOADS
    rep = benchmark.main(TINY + ["--json", "--max-tokens", "12"])
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == json.loads(json.dumps(rep))
    jax_keys = set(json.loads(jax_bench.Report().as_json()))
    assert set(rep) - jax_keys == {"device", "peak_memory_gb"}
    assert jax_keys <= set(rep)
    assert rep["device"] == "cpu" and rep["peak_memory_gb"] is None
    fl = TINY_VOCODER_CONFIG.frame_length
    assert [r["name"] for r in rep["rows"]] == [n for n, _ in jax_bench.WORKLOADS]
    for r in rep["rows"]:
        assert r["frames"] == 11  # 12 generated, the final one stripped
        assert r["audio_s"] == round(r["frames"] * fl / 44100, 3)
    assert rep["streaming"]["ttfa_s"] > 0 and rep["batch"]["streams"] == 3
    assert set(rep["streaming"]) == {"ttfa_s", "audio_s", "wall_s", "rtf", "chunks"}
    assert rep["components"]["tokens"] == 3 * 12 and set(rep["components"]["phases"]) >= {
        "prefill", "vocoder"}
    # the smoke's check of the report holds on it (the tiny codec's frame is 2048 samples)
    assert fl == 2048
    chip_smoke.check_report(rep, "tiny")


def test_benchmark_needs_a_model_source():
    with pytest.raises(SystemExit):
        benchmark.main(["--device", "cpu"])


def test_verify_sampler_exits_zero_at_full_width(capsys):
    assert verify_sampler.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("vocab: 155776")
    cases = [ln for ln in lines if ln.startswith("B=")]
    assert len(cases) == 18 and all(ln.endswith(": OK") for ln in cases)


def test_verify_sampler_flags_a_flipped_row(monkeypatch, capsys):
    orig = verify_sampler.sampling.sample

    def flipped(gumbel, logits, *a, **kw):
        out = orig(gumbel, logits, *a, **kw).clone()
        out[-1] = (out[-1] + 1) % logits.shape[-1]
        return out

    monkeypatch.setattr(verify_sampler.sampling, "sample", flipped)
    assert verify_sampler.main(["--device", "cpu"]) == 1
    cases = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("B=")]
    assert len(cases) == 18 and all(ln.endswith(": 1 MISMATCH") for ln in cases)


GATE_ARGS = ["-b", "2", "--kv", "64", "--pos", "10", "--chunks", "1"]


def _supports():
    return (sampler_kernel.supports, fast_decoder.supports, slow_stack.supports)


def test_kernel_gates_turn_off_one_part_per_row(monkeypatch):
    orig_route, seen = decode.route, []

    def spy(*a, **kw):
        rt = orig_route(*a, **kw)
        seen.append((rt.slow_stack, rt.sampler, rt.fast))
        return rt

    monkeypatch.setattr(decode, "route", spy)
    before = _supports()
    records = ab_kernel_gates.main(TINY + GATE_ARGS)
    assert _supports() == before
    want = [(True, True, True), (True, False, True), (True, True, False), (False, True, True)]
    assert [r["label"] for r in records] == list(ab_kernel_gates.GATES)
    assert [(r["route"]["slow_stack"], r["route"]["sampler"], r["route"]["fast"])
            for r in records] == want
    # the frames ran on each row's route, in the rows' order
    groups = [rt for i, rt in enumerate(seen) if i == 0 or rt != seen[i - 1]]
    assert groups == want
    for r in records:
        assert r["frames"] == (1 + 3 * 1) * ab_kernel_gates.CHUNK
        assert r["ms_per_frame"] > 0 and math.isfinite(r["aggregate_frames_per_s"])
        # on the CPU the kernels' plain versions run and count nothing
        assert r["launches"] == dict.fromkeys(r["launches"], 0)


def test_smoke_gate_check():
    """The smoke's check of the gate rows on the card: the gated-off kernel at
    0 launches, every other one per frame the row ran."""
    frames = (1 + 3 * 2) * ab_kernel_gates.CHUNK
    names = [name for _, name in ab_kernel_gates.KERNELS]
    rows = [{"label": label, "ms_per_frame": 5.0, "frames": frames,
             "launches": {n: 0 if chip_smoke.GATE_KERNELS.get(label) == n else frames
                          for n in names}} for label in ab_kernel_gates.GATES]
    assert "slow-stack kernel OFF" in chip_smoke.check_gates(rows, 2)
    rows[1]["launches"]["sample_slow"] = frames
    with pytest.raises(SystemExit, match="sampler kernel OFF"):
        chip_smoke.check_gates(rows, 2)


def test_kernel_gates_restore_supports_after_an_exception(monkeypatch):
    calls = []
    orig = ab_kernel_gates.time_chunks

    def failing(*a, **kw):
        calls.append(1)
        if len(calls) == 2:  # mid-run: the sampler's gate is patched off
            assert sampler_kernel.supports(1, -1) is False
            raise RuntimeError("boom")
        return orig(*a, **kw)

    monkeypatch.setattr(ab_kernel_gates, "time_chunks", failing)
    before = _supports()
    with pytest.raises(RuntimeError, match="boom"):
        ab_kernel_gates.main(TINY + GATE_ARGS)
    assert _supports() == before
    assert sampler_kernel.supports(1, -1)


def test_kvbucket_skips_an_out_of_contract_bucket(capsys):
    records = ab_kvbucket.main(TINY + ["-b", "2", "--buckets", "64", "16", "--pos", "10",
                                       "--chunks", "1"])
    out = capsys.readouterr().out
    assert "kv_bucket=16: skipped (pos+frames exceeds bucket)" in out
    assert [r["kv_bucket"] for r in records] == [64]
    assert records[0]["ms_per_frame"] > 0 and records[0]["device"] == "cpu"


def _tiny_session():
    tts = FishTTS(device="cpu", precision="fp32", warmup=False,
                  _testing_bundle=testing.make_tiny_bundle(0))
    return tts.serve(slots=2, warmup=False)


def _wrapped_attrs(sess):
    return (decode.DecodeGraph.run, decode.decode_chunk,
            serve_mod.ContinuousBatcher._process, sess.__dict__.get("_emit"),
            sess._srv.__dict__.get("step"), sess._decode)


def test_profile_serving_restores_what_it_wraps():
    sess = _tiny_session()
    before = _wrapped_attrs(sess)
    phases = profile_serving.Phases(torch.device("cpu"))
    with profile_serving.instrument(sess, phases):
        during = _wrapped_attrs(sess)
        assert all(a is not b for a, b in zip(during, before))
        sess.submit("hi", max_new_tokens=6)
        for _ in sess.run():
            pass
    assert _wrapped_attrs(sess) == before
    assert set(phases.host) == SERVE_LABELS and phases.device_s("lm_step") is None
    with pytest.raises(RuntimeError, match="boom"):
        with profile_serving.instrument(sess, phases):
            raise RuntimeError("boom")
    assert _wrapped_attrs(sess) == before


def test_profile_serving_rows():
    records = profile_serving.main(TINY + ["--slots", "2", "--requests", "3", "--budget", "12"])
    labels = [r["label"].strip() for r in records]
    assert labels == ["lm_step (total)", "lm_dispatch", "lm_frames_fetch+route",
                      "lm sched remainder", *labels[4:6], "host_other (rest of step)",
                      "TOTAL step", "aggregate"]
    assert set(labels[4:6]) == {"voc_dispatch", "audio_fetch+convert"}
    check_finite([r for r in records if r["label"] != "aggregate"])
    agg = records[-1]
    assert agg["frames"] == 3 * 12 and agg["frames_per_s"] > 0
    assert all(r["device_ms_per_round"] is None for r in records[:-1])


def test_timing_helpers_on_the_cpu():
    dev = torch.device("cpu")
    assert _timing.device_line(dev) == "cpu" and _timing.clock_name(dev) == "host clock"
    seen = []
    loop = _timing.Loop(seen.append, 3, dev)
    assert loop.how == "host clock" and seen == []
    per, note = _timing.time_loop(loop, dev, 2)
    assert seen == [0, 1, 2, 0, 1, 2] and per >= 0 and note == ""
    s, host = _timing.timed(lambda: None, dev)
    assert s == host >= 0


@pytest.mark.parametrize("mod, argv", [
    (benchmark, ["--tiny"]), (verify_sampler, []), (ab_kernel_gates, ["--tiny"]),
    (ab_kvbucket, ["--tiny"]), (profile_decode, ["--tiny"]), (profile_batch, ["--tiny"]),
    (profile_slow_parts, ["--tiny"]), (profile_vocoder, ["--tiny"]),
    (profile_serving, ["--tiny"]),
])
def test_cuda_without_a_card_raises(mod, argv):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        mod.main(argv)  # --device defaults to cuda
