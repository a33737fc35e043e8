"""The port's Unicode-table generator
(``fish_tts_tpu_torch/native/gen_unicode_tables.py``) against the JAX one:
it writes the port's shipped ``unicode_tables.h`` byte for byte, and its L,
N and P tables equal the JAX generator's ranges of its own probe."""

import pytest
from test_torch_stream import one_thread  # noqa: F401 (an autouse fixture)

from fish_tts_tpu.native import gen_unicode_tables as jax_gen
from fish_tts_tpu_torch.native import gen_unicode_tables as gen


def test_generated_header_is_the_shipped_one(tmp_path):
    pytest.importorskip("tiktoken")
    out = tmp_path / "unicode_tables.h"
    ranges = gen.main(["--out", str(out)])
    assert out.read_bytes() == gen.HEADER.read_bytes()
    for name, pat in (("kTableL", r"\p{L}"), ("kTableN", r"\p{N}"), ("kTableP", r"\p{P}")):
        assert ranges[name] == jax_gen._to_ranges(jax_gen._probe_tiktoken(pat)), name
