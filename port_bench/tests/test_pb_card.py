"""On a CUDA card: one short run of each cell proves correct.  Run there
with ``python -m pytest port_bench/tests -m card``; skipped elsewhere."""

import json
from pathlib import Path

import pytest

from port_bench import run

MAN = json.loads((Path(__file__).resolve().parents[2] / "BENCHMARK.json").read_text())


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_cell_runs_correct_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    run.cache_dirs()
    res = run.run_cell(MAN, {w["name"]: w for w in MAN["workloads"]}[cell], 2**31 + 99, 5.0,
                       False)
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["metrics"]["setup_s"]["value"] > 0
