"""A new configuration (with its own LM reference and weight draw), mix or
metric is a new file, found by its name with no edit to a file that is
there."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

PROBE = r"""
import json, sys
from port_bench import check, run, weights
from port_bench.reference import prompt
raw = run.load_json("configs", "extra-ref-config")
check.refuse(raw)
cfg = run.config_of(raw)
ids = prompt.ids(cfg["model"]["codebook_size"])
lm = run.lm_weights(cfg, 3, ids, "cpu")
judge = check.Judge(lm, weights.codec(cfg["codec"], 3, "cpu"), cfg, ids, "fp32")
print(json.dumps({
    "config": run.load_json("configs", "extra-config")["precision"],
    "traffic": run.load_json("traffic", "extra-mix")["kind"],
    "metric": run.reader("extra_metric")(run.Run(t0=0.0, t1=2.0)),
    "cells": [m["name"] for m in run.cell_metrics(run.manifest(), "extra-cell", True)],
    "reference": check.reference(cfg).__file__.rsplit("port_bench", 1)[1],
    "drawn": lm["extra_leaf"].tolist(),
    "judge": type(judge.lm).__name__ + "." + judge.lm.extra,
}))
"""

# a new reference: the stand-ins' with one more leaf in its weight draw
EXTRA_REFERENCE = """
from port_bench import weights
from port_bench.reference import dual_ar

SIZES, FLAGS = dual_ar.SIZES, dual_ar.FLAGS


def lm_specs(cfg):
    return weights.lm_specs(cfg) + [(("extra_leaf",), (2,), ("const", 7.0))]


class DualAR(dual_ar.DualAR):
    extra = "used"
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
    tiny = json.loads((tmp_path / "port_bench/tests/tiny_config.json").read_text())
    tiny["reference"] = "extra_ref"
    (tmp_path / "port_bench/configs/extra-ref-config.json").write_text(json.dumps(tiny))
    (tmp_path / "port_bench/reference/extra_ref.py").write_text(EXTRA_REFERENCE)
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
                   "cells": ["extra_metric"], "reference": "/reference/extra_ref.py",
                   "drawn": [7.0, 7.0], "judge": "DualAR.used"}
    # the files that were there are as they were
    for p, data in before.items():
        assert p.read_bytes() == data
