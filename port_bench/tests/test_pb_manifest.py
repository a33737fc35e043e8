"""BENCHMARK.json against the contract's limits, and the files it names."""

import json
import re
from pathlib import Path

from port_bench import run

ROOT = Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_keys_and_names():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in MAN[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in MAN["workloads"]:
        assert NAME.match(w["traffic"]) and w["chips"] == 1 and len(w["why"]) <= 200
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) < 64 * 1024


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in MAN["workloads"]:
        e2e = [m["name"] for m in run.cell_metrics(MAN, w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert run.cell_metrics(MAN, w["name"], True)


def test_per_layer_cells_report_their_moves():
    for m in MAN["per_layer"]:
        for cell in m["workloads"]:
            e2e = [x["name"] for x in run.cell_metrics(MAN, cell, False)]
            assert m["moves"] in e2e, (m["name"], cell)
    layers = {}
    for m in MAN["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
    assert all("\n" not in k and k for k in layers)


def test_files_found_by_name():
    for c in MAN["configs"]:
        path = ROOT / c["file"]
        assert path.parent == ROOT / "port_bench" / "configs" and path.stem == c["name"]
        data = json.loads(path.read_text())
        assert data["reduced"] == c["reduced"] and data["source"] == c["source"]
        assert all(isinstance(k, str) and k for k in c["reduced"])
    for w in MAN["workloads"]:
        assert (ROOT / "port_bench" / "traffic" / f"{w['traffic']}.json").exists()
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert callable(run.reader(m["name"]))
    for path in MAN["paths"]:
        assert (ROOT / path).is_dir() and not path.endswith("_torch")


def test_command_stays_in_paths():
    assert MAN["command"] == ["python3", "-m", "port_bench"]
    assert MAN["paths"] == ["port_bench"]


def test_limits_name_numbers_the_check_makes():
    from port_bench import check

    made = set(check.NUMBERS) | {"frames_missing", "pcm_samples_off"}
    for c in MAN["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["limits"] and set(data["limits"]) <= made, c["name"]
        assert {"mean_gap", "fast_gap", "pcm_err"} <= set(data["limits"])
