"""The port's claims check (``fish_tts_tpu_torch/scripts/check_claims.py``)
against the JAX ``scripts/check_claims.py``, and the port's claims file:

- the port's ``check`` gives the JAX ``check``'s messages on the same dicts:
  larger- and smaller-is-better keys, ``_`` keys, values that are not
  numbers, zeros, and the edge at exactly the tolerance;
- only a card's bench record counts: a TPU ``BENCH_r*.json`` is ignored,
  and with none left there is nothing to check (exit 0); ``--bench FILE``
  checks an explicit line (exit 1 on a drift);
- every numeric key of ``fish_tts_tpu_torch/CLAIMS.json`` is a key of the
  port's bench line, and its ``_source`` names an NVIDIA card and a power
  limit;
- the bench's epilogue checks its line against the claims only when the
  line is of the claims' precision.
"""

import importlib.util
import json
import re
from pathlib import Path

import pytest
from test_torch_stream import one_thread  # noqa: F401 (an autouse fixture)

import chip_smoke
from fish_tts_tpu_torch.scripts import bench, check_claims

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("jax_check_claims",
                                               ROOT / "scripts" / "check_claims.py")
jax_check_claims = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jax_check_claims)

CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
MEASURED = {"value": 100.0, "rtf": 0.04, "ttfa_ms": 200.0, "serve_tok_per_sec": 2000.0,
            "vocoder_frames_per_sec": 3000.0, "serve_audio_x_realtime": 50.0, "init_s": 10.0,
            "precision": "int8", "device": CARD, "zero_tok_per_sec": 0.0}
CASES = {
    "larger is better, rosier": {"value": 130.0, "serve_tok_per_sec": 2100.0},
    "larger is better, worse": {"value": 60.0, "vocoder_frames_per_sec": 10.0},
    "smaller is better, rosier": {"rtf": 0.02, "ttfa_ms": 100.0, "init_s": 1.0},
    "smaller is better, worse": {"rtf": 0.08, "ttfa_ms": 900.0},
    "underscore keys": {"_source": "x", "_value": 1e9, "value": 100.0},
    "not numbers": {"value": "fast", "precision": "int8", "rtf": None, "ttfa_ms": [1.0]},
    "measured zero or absent": {"zero_tok_per_sec": 5.0, "not_measured_ms": 1.0},
    "claimed zero, larger is better": {"value": 0, "serve_audio_x_realtime": 0.0},
    "at the tolerance": {"value": 115.0, "rtf": 0.04 / 1.15, "ttfa_ms": 200.0 / 1.15},
    "just past the tolerance": {"value": 115.01, "rtf": 0.0347, "ttfa_ms": 173.9},
    "bools are numbers": {"value": True},
}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("tol", [0.15, 0.0])
def test_check_equals_the_jax_check(name, tol):
    claims = CASES[name]
    want = jax_check_claims.check(claims, MEASURED, tol)
    assert check_claims.check(claims, MEASURED, tol) == want


def test_a_claimed_zero_of_a_smaller_is_better_key_raises_in_both():
    for mod in (check_claims, jax_check_claims):
        with pytest.raises(ZeroDivisionError):
            mod.check({"rtf": 0.0}, MEASURED, 0.15)


def test_only_card_records_count(tmp_path, capsys):
    def record(n: int, device: str) -> None:
        (tmp_path / f"BENCH_r{n:02d}.json").write_text(
            json.dumps({"parsed": dict(MEASURED, device=device)}))

    record(7, "TPU v5 lite")
    assert check_claims.newest_bench(tmp_path) is None
    assert check_claims.main([], root=tmp_path) == 0
    assert "nothing to check" in capsys.readouterr().err
    record(3, CARD)
    record(5, "cpu")
    assert check_claims.newest_bench(tmp_path) == ("BENCH_r03.json", dict(MEASURED, device=CARD))
    # the repository's own records that name no NVIDIA card (the JAX bench's
    # TPU lines) are skipped; a card record, once recorded there, is newest
    others = tmp_path / "others"
    others.mkdir()
    for f in ROOT.glob("BENCH_r*.json"):
        if "nvidia" not in f.read_text().lower():
            (others / f.name).write_bytes(f.read_bytes())
    assert check_claims.newest_bench(others) is None
    newest = check_claims.newest_bench()
    assert newest is None or check_claims.is_card_record(newest[1])


def test_explicit_bench_file(tmp_path, capsys):
    claims = json.loads(check_claims.CLAIMS.read_text())
    keys = [k for k, v in claims.items() if not k.startswith("_") and isinstance(v, (int, float))]
    backed = tmp_path / "backed.json"
    backed.write_text(json.dumps({k: claims[k] for k in keys}))
    assert check_claims.main(["--bench", str(backed)]) == 0
    rosier = {k: claims[k] * (0.5 if check_claims.LARGER_IS_BETTER.search(k) else 2.0)
              for k in keys}
    (tmp_path / "rosier.json").write_text(json.dumps({"parsed": rosier}))
    assert check_claims.main(["--bench", str(tmp_path / "rosier.json")]) == 1
    assert "CLAIMS DRIFT" in capsys.readouterr().err


def test_claims_file_holds_card_numbers_under_bench_keys():
    claims = json.loads(check_claims.CLAIMS.read_text())
    line_keys = (chip_smoke.BENCH_DECODE_KEYS | chip_smoke.BENCH_USER_KEYS
                 | {"aggregate_tok_per_sec_b8", "aggregate_tok_per_sec_b16"})
    numeric = {k for k, v in claims.items() if not k.startswith("_")}
    assert numeric and numeric <= line_keys
    assert all(isinstance(claims[k], (int, float)) and claims[k] > 0 for k in numeric)
    assert "NVIDIA" in claims["_source"]
    assert re.search(r"\d+\.\d+ W", claims["_source"])
    assert "TPU" not in claims["_source"]


def test_bench_checks_only_a_line_of_the_claims_precision():
    claims = json.loads(check_claims.CLAIMS.read_text())
    line = {k: v for k, v in claims.items() if not k.startswith("_")}
    line["precision"] = claims["_precision"]
    assert bench.claims_drift(line) == []
    slower = dict(line, value=line["value"] / 2)
    assert [d.split(":")[0] for d in bench.claims_drift(slower)] == ["value"]
    assert bench.claims_drift(dict(slower, precision="bf16")) is None
