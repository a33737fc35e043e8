"""The fast decoder's decision-margin check and its wrapper's host work, on
the CPU.

- ``testing.fast_decision_margins`` (what ``chip_smoke.py`` holds the fast
  decoder's kernel to): a differing code is excused only at a knife edge
  of the plain version's own numbers, and positions after a stream's first
  difference are not compared;
- ``ops.fast_decoder._prepare``: the weights are checked and converted once
  per parameter set, and again for another dict or another tensor.
"""

import math

import pytest
import torch

from fish_tts_tpu_torch import testing
from fish_tts_tpu_torch.ops import fast_decoder as fd
from fish_tts_tpu_torch.testing import fast_decision_margins, make_tiny_bundle
from fish_tts_tpu_torch.utils.quantize import quantize_lm_params

TEMP, TOL = 0.7, 0.01


def _frame(logits0, top_p, gumbel0):
    """One stream, two positions: position 0 as given, position 1 a copy of
    it with no noise.  Returns the plain version's (codes, logits, gumbel)."""
    l0 = torch.tensor(logits0, dtype=torch.float32)
    logits = torch.stack([l0, l0])[None]
    gumbel = torch.zeros_like(logits)
    gumbel[0, 0] = torch.tensor(gumbel0, dtype=torch.float32)
    keep = fd.top_p_pairwise_keep(logits[0], torch.full((2, 1), top_p))
    scores = torch.where(keep, logits[0], torch.full_like(logits[0], fd.NEG)) / TEMP + gumbel[0]
    codes = scores.argmax(dim=-1).to(torch.int32)[None]
    return codes, logits, gumbel


def _case(name):
    """(plain codes, kernel codes, plain logits, kernel logits, gumbel,
    top_p, expected (knife edges, failures, positions compared))."""
    flat = [2.0, 1.0, 0.5, 0.3, 0.2, 0.1, 0.0, -1.0]
    if name in ("near_tie", "after_divergence", "clear", "logits_off"):
        # lane 1's Gumbel score beats lane 0's by 0.01 (near tie) or 1.57
        lift = 0.01 if name != "clear" else 1.57
        g = [0.0] * len(flat)
        g[1] = (flat[0] - flat[1]) / TEMP + lift
        codes_p, logits_p, gumbel = _frame(flat, 1.0, g)
        assert codes_p[0, 0] == 1
        codes, logits = codes_p.clone(), logits_p.clone()
        top_p = 1.0
        if name == "logits_off":  # same codes, logits apart by more than tol
            logits[0, 0, 3] += 0.5
            want = (0, 1, 1)
        else:
            codes[0, 0] = 0  # the kernel took the runner-up
            if name == "after_divergence":  # later inputs differ: not compared
                logits[0, 1] += 5.0
                codes[0, 1] = 7
            want = (0, 1, 1) if name == "clear" else (1, 0, 1)
    else:  # top_p_edge: lane 1's mass above it plus its own is 1e-4 under top_p
        probs = [0.5, 0.3, 0.1, 0.05, 0.05]
        top_p = 0.8 + 1e-4
        g = [0.0, 5.0, 0.0, 0.0, 0.0]
        codes_p, logits_p, gumbel = _frame([math.log(p) for p in probs], top_p, g)
        assert codes_p[0, 0] == 1
        codes, logits = codes_p.clone(), logits_p.clone()
        codes[0, 0] = 0  # the kernel dropped lane 1 at the edge
        want = (1, 0, 1)
    return codes_p, codes, logits_p, logits, gumbel, top_p, want


@pytest.mark.parametrize("name", ["near_tie", "clear", "top_p_edge", "after_divergence",
                                  "logits_off"])
def test_fast_decision_margins(name):
    codes_p, codes, logits_p, logits, gumbel, top_p, want = _case(name)
    out = fast_decision_margins(codes, codes_p, logits, logits_p, gumbel,
                                torch.full((1, 1), TEMP), torch.full((1, 1), top_p), TOL)
    assert (out["knife_edges"], len(out["failures"]), out["compared"]) == want, out
    assert out["max_abs_err"] >= 0.0


@pytest.mark.parametrize("change", ["none", "new_tensor", "new_dict"])
def test_prepare_checks_once_per_parameter_set(monkeypatch, change):
    """The weight checks run on the first call and again only for another
    dict or a dict holding another tensor."""
    cfg, params, *_ = make_tiny_bundle(0)
    params = quantize_lm_params(params)
    rope = torch.zeros((cfg.num_codebooks, cfg.fast_head_dim // 2, 2), dtype=torch.bfloat16)
    checked = []
    monkeypatch.setattr(fd.kernels, "require_cuda", lambda name, *a, **k: checked.append(name))
    monkeypatch.setattr(fd, "_prepared", None)
    first = fd._prepare(params, cfg, rope)
    n_checks = len(checked)
    assert n_checks == 18 and first[0] is rope  # 8 tensors, 5 matrices with scales
    if change == "new_tensor":
        params["fast_norm"] = params["fast_norm"].clone()
    elif change == "new_dict":
        params = dict(params)
    again = fd._prepare(params, cfg, rope)
    if change == "none":
        assert again is first and len(checked) == n_checks
    else:
        assert len(checked) == 2 * n_checks
        assert [t.data_ptr() for t in again[3:13]] == [t.data_ptr() for t in first[3:13]]


def test_mass_above_sorted_matches_pairwise(monkeypatch):
    """Past ``PAIRWISE_LANES`` the mass above each lane comes from one sort
    (the slow token's width would need a V x V matrix): the same values as
    the pairwise sum, ties included."""
    gen = torch.Generator().manual_seed(3)
    logits = torch.randn(3000, generator=gen, dtype=torch.float64)
    logits[5] = logits[7] = logits[11]
    p = torch.softmax(logits, dim=-1)
    pairwise = testing._mass_above(logits, p)
    monkeypatch.setattr(testing, "PAIRWISE_LANES", 10)
    torch.testing.assert_close(testing._mass_above(logits, p), pairwise, rtol=0, atol=1e-12)
