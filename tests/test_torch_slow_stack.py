"""The slow-stack wrapper's host work, on the CPU.

``ops.slow_stack._prepare``: the weights are checked and converted once per
parameter set, and again for another dict or another tensor.
"""

import pytest
import torch

from fish_tts_tpu_torch.models.dual_ar import make_rope_tables
from fish_tts_tpu_torch.ops import slow_stack as ss
from fish_tts_tpu_torch.testing import make_tiny_bundle
from fish_tts_tpu_torch.utils.quantize import quantize_lm_params


@pytest.mark.parametrize("change", ["none", "new_tensor", "new_dict"])
def test_prepare_checks_once_per_parameter_set(monkeypatch, change):
    """The weight checks run on the first call and again only for another
    dict or a dict holding another tensor."""
    cfg, params, *_ = make_tiny_bundle(0)
    params = quantize_lm_params(params)
    rope = make_rope_tables(cfg)["slow"]
    checked = []
    monkeypatch.setattr(ss.kernels, "require_cuda", lambda name, *a, **k: checked.append(name))
    monkeypatch.setattr(ss, "_prepared", None)
    first = ss._prepare(params, cfg, rope)
    n_checks = len(checked)
    assert n_checks == 16 and first[0] is rope  # 6 tensors, 5 matrices with scales
    if change == "new_tensor":
        params["norm"] = params["norm"].clone()
    elif change == "new_dict":
        params = dict(params)
    again = ss._prepare(params, cfg, rope)
    if change == "none":
        assert again is first and len(checked) == n_checks
    else:
        assert len(checked) == 2 * n_checks
        assert [t.data_ptr() for t in again[3:13]] == [t.data_ptr() for t in first[3:13]]
