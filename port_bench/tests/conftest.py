"""Tests of the benchmark harness.  They run on the CPU; a test that needs a
CUDA card is marked ``card`` and skips without one."""

import json
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def tiny_config() -> dict:
    return json.loads((HERE / "tiny_config.json").read_text())


SAMPLING = {"temperature": 0.7, "top_p": 0.8, "repetition_penalty": 1.1}
TINY_MIXES = {
    "serve_closed": {"kind": "serve_closed", "slots": 4, "outstanding": 8,
                     "prompt_tokens": [20, 30], "frames": [20, 40], "grid": 8, "greedy_every": 2,
                     "sampling": SAMPLING},
    "serve_open": {"kind": "serve_open", "slots": 4, "rate_per_s": 4.0, "prompt_tokens": [10, 19],
                   "frames": [10, 30], "grid": 8, "greedy_every": 2, "sampling": SAMPLING,
                   "voices": {"frames": [5, 9], "text_chars": [5, 8]}},
    "stream_closed": {"kind": "stream_closed", "prompt_tokens": [20, 30], "frames": [20, 40],
                      "grid": 8, "greedy_every": 2, "sampling": SAMPLING},
}
