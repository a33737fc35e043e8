"""A new configuration, mix or metric is a new file, found by its name with
no edit to a file that is there."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

PROBE = r"""
import json, sys
from port_bench import run
print(json.dumps({
    "config": run.load_json("configs", "extra-config")["precision"],
    "traffic": run.load_json("traffic", "extra-mix")["kind"],
    "metric": run.reader("extra_metric")(run.Run(t0=0.0, t1=2.0)),
    "cells": [m["name"] for m in run.cell_metrics(run.manifest(), "extra-cell", True)],
}))
"""


def test_new_files_are_found(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "port_bench").rglob("*") if p.is_file()}
    base = json.loads((tmp_path / "port_bench/configs/s1mini-int8.json").read_text())
    base["precision"] = "bf16"
    (tmp_path / "port_bench/configs/extra-config.json").write_text(json.dumps(base))
    mix = json.loads((tmp_path / "port_bench/traffic/solo-stream.json").read_text())
    (tmp_path / "port_bench/traffic/extra-mix.json").write_text(json.dumps(mix))
    (tmp_path / "port_bench/metrics/extra_metric.py").write_text(
        "def read(run):\n    return run.window_s * 10\n")
    man = json.loads((tmp_path / "BENCHMARK.json").read_text())
    man["workloads"].append({"name": "extra-cell", "config": "extra-config",
                             "traffic": "extra-mix", "chips": 1, "why": "probe"})
    man["per_layer"].append({"name": "extra_metric", "unit": "ms", "better": "lower",
                             "source": "host_clock", "layer": "probe",
                             "moves": "pcm_gap_p95_ms", "workloads": ["extra-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=tmp_path, capture_output=True,
                         text=True, check=True).stdout
    got = json.loads(out)
    assert got == {"config": "bf16", "traffic": "stream_closed", "metric": 20.0,
                   "cells": ["extra_metric"]}
    # the files that were there are as they were
    for p, data in before.items():
        assert p.read_bytes() == data
