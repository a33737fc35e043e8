"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program; names are compared whole, by the
part before the first dot (the port's name begins with the JAX package's)."""

import ast
import subprocess
import sys
from pathlib import Path

from port_bench import run

PKG = Path(__file__).resolve().parents[1]
JAX_SIDE = {"jax", "jaxlib", "flax", "fish_tts_tpu"}


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".", 1)[0])
    return names


def test_no_jax_anywhere_under_the_harness():
    for path in PKG.rglob("*.py"):
        assert not top_level_imports(path) & JAX_SIDE, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (PKG / "reference").rglob("*.py"):
        names = top_level_imports(path)
        assert "fish_tts_tpu_torch" not in names and not names & JAX_SIDE, path


def test_guard_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "fish_tts_tpu_torch_extra", sys)
    assert "fish_tts_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "fish_tts_tpu.models", sys)
    assert run.forbidden_modules() == ["fish_tts_tpu"]


def test_a_run_loads_no_jax():
    """Importing the harness and the program it drives loads no JAX."""
    code = ("import sys, port_bench.run, port_bench.check, port_bench.drive, "
            "fish_tts_tpu_torch.synthesizer; "
            "print(sorted({n.split('.')[0] for n in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'fish_tts_tpu'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent, capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"


def test_no_card_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        return  # the refusal is what a card-less host sees
    assert run.main(["--workload", "int8-backlog", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""
