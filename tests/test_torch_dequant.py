"""The fast decoder's dequant modes in the port against the JAX package, at
tiny size on the CPU: the plain ``"s8"`` version (activation rows quantized
to int8 by their absmax, s8 x s8 products) against the JAX Pallas kernel's
``dequant="s8"`` in interpret mode, ``"s8"`` against ``"value"``,
``"scratch"`` against ``"value"``, the unknown mode, the port's A/B
script ``fish_tts_tpu_torch.scripts.ab_fast_decoder``, and the row-by-row
check that holds the ``"s8"`` kernel against its plain version on the card
(``testing.s8_plain_trace``, ``testing.s8_decision_margins``), fed traces
made from the plain version's own rows.

Tolerances: against JAX, logits within ``S8_TOL`` of their largest
magnitude (the products are exact integer sums; only a quantization step
that rounds to the other integer, or the f32 norms and attention, differ)
and codes equal, a differing one excused only at a knife edge of the JAX
kernel's own numbers (``testing.fast_decision_margins``); ``"s8"`` within
3% of the ``"value"`` logits' range (the JAX test's own bound,
``tests/test_fast_decoder.py::test_dequant_modes_agree``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_tts_tpu.config import TINY_CONFIG as J_CFG
from fish_tts_tpu.engine import decode as jdecode
from fish_tts_tpu.models import dual_ar as jdual
from fish_tts_tpu.ops import fast_decoder as jfast
from fish_tts_tpu.utils.quantize import quantize_lm_params
from fish_tts_tpu_torch import testing
from fish_tts_tpu_torch.config import TINY_CONFIG as T_CFG
from fish_tts_tpu_torch.models import dual_ar as tdual
from fish_tts_tpu_torch.ops import fast_decoder as tfast
from fish_tts_tpu_torch.scripts import ab_fast_decoder
from fish_tts_tpu_torch.utils import checkpoint as tckpt
from test_torch_stream import one_thread  # noqa: F401 (an autouse fixture)

S8_TOL = 1e-4
K, Vr, W = T_CFG.num_codebooks, T_CFG.residual_codebook_size, jdecode.WINDOW
SAMPLING = (0.7, 0.8, 1.1)


@pytest.fixture(scope="module")
def qparams():
    """The JAX test's int8 tiny parameters: (JAX tree, the port's)."""
    jp = quantize_lm_params(jdual.init_params(jax.random.PRNGKey(0), J_CFG, jnp.float32))
    return jp, tckpt.from_jax_params(jax.tree_util.tree_map(np.asarray, jp))


def inputs(case: str):
    """(h, a0, prev, gumbel) as numpy: the JAX test's own (B = 2, drawn with
    its keys) or seeded numpy ones."""
    if case == "jax-test B=2":
        h = np.asarray(jax.random.normal(jax.random.PRNGKey(50), (2, J_CFG.fast_dim)) * 0.4)
        g = np.asarray(jax.random.gumbel(jax.random.PRNGKey(51), (2, K - 1, Vr)))
        return h, np.asarray([7, 3], np.int32), np.zeros((2, K - 1, W), np.int32), g
    B = int(case[-1])
    rng = np.random.default_rng(60 + B)
    return (rng.standard_normal((B, T_CFG.fast_dim)).astype(np.float32) * 0.4,
            rng.integers(0, T_CFG.codebook_size, B).astype(np.int32),
            rng.integers(0, Vr, (B, K - 1, W)).astype(np.int32),
            rng.gumbel(size=(B, K - 1, Vr)).astype(np.float32))


def port(tp, args, mode):
    h, a0, prev, g = (torch.from_numpy(np.array(x)) for x in args)
    return tfast.fast_decode_frame(tp, T_CFG, tdual.make_rope_tables(T_CFG)["fast"], h, a0,
                                   prev, g, *SAMPLING, window=W, dequant=mode)


def jax_run(jp, args, mode):
    h, a0, prev, g = (jnp.asarray(x) for x in args)
    codes, logits = jfast.fast_decode_frame(
        jp, J_CFG, jdual.make_rope_tables(J_CFG)["fast"], h, a0, prev, g,
        *(jnp.float32(v) for v in SAMPLING), window=W, interpret=True, dequant=mode)
    return torch.from_numpy(np.array(codes)), torch.from_numpy(np.array(logits))


@pytest.mark.parametrize("case", ["jax-test B=2", "numpy B=1", "numpy B=3"])
def test_s8_plain_matches_pallas(qparams, case):
    jp, tp = qparams
    args = inputs(case)
    codes, logits = port(tp, args, "s8")
    codes_j, logits_j = jax_run(jp, args, "s8")
    tol = S8_TOL * float(logits_j.abs().max())
    m = testing.fast_decision_margins(codes, codes_j, logits, logits_j,
                                      torch.from_numpy(np.array(args[3])), SAMPLING[0],
                                      SAMPLING[1], tol)
    assert not m["failures"], m["failures"]
    assert m["compared"] >= codes.numel() - m["knife_edges"] * (K - 2)


@pytest.mark.parametrize("case", ["jax-test B=2", "numpy B=1"])
def test_s8_within_three_percent_of_value(qparams, case):
    """``"s8"`` logits within 3% of the ``"value"`` logits' range, every
    sampled ``"s8"`` code inside its own nucleus."""
    _, tp = qparams
    args = inputs(case)
    _, logits_v = port(tp, args, "value")
    codes_s, logits_s = port(tp, args, "s8")
    assert (logits_s - logits_v).abs().max() <= 0.03 * logits_v.abs().max()
    keep = tfast.top_p_pairwise_keep(logits_s.reshape(-1, Vr),
                                     torch.full((codes_s.numel(), 1), SAMPLING[1]))
    assert keep.gather(1, codes_s.reshape(-1, 1).long()).all()


def test_scratch_equals_value_to_the_bit(qparams):
    _, tp = qparams
    args = inputs("numpy B=3")
    for a, b in zip(port(tp, args, "scratch"), port(tp, args, None)):
        assert torch.equal(a, b)
    for a, b in zip(port(tp, args, "value"), port(tp, args, None)):
        assert torch.equal(a, b)


def test_unknown_mode_raises(qparams):
    _, tp = qparams
    args = inputs("numpy B=1")
    with pytest.raises(ValueError, match="dequant must be one of"):
        port(tp, args, "fp8")
    with pytest.raises(ValueError, match="dequant must be one of"):
        tfast.supports(T_CFG, tp, 1, W, dequant="int4")
    assert all(tfast.supports(T_CFG, tp, 1, W, dequant=m) for m in tfast.DEQUANT_MODES)
    assert tfast.DEQUANT_MODES == jfast.DEQUANT_MODES
    assert tfast.DEFAULT_DEQUANT == jfast.DEFAULT_DEQUANT


def test_s8dot_quantizes_as_the_pallas_kernel():
    """``s8dot`` on rows with exact halves: ties round to even, an all-zero
    row gives zeros (the 1e-30 guard), and the result is ``(acc * sc) * s``."""
    x = torch.tensor([[127.0, -63.5, 0.5, 1.5], [0.0, 0.0, 0.0, 0.0]])
    w = {"q": torch.tensor([[1, 1, 1, 1], [0, 2, 4, 6]], dtype=torch.int8),
         "s": torch.tensor([[0.5], [0.25]])}
    out = tfast.s8dot(x, w)
    xq = torch.tensor([127, -64, 0, 2])  # sc = 1: -63.5 -> -64, 0.5 -> 0, 1.5 -> 2
    want = torch.stack([(xq * w["q"][0]).sum(), (xq * w["q"][1]).sum()]).float()
    assert torch.equal(out[0], want * w["s"][:, 0])
    assert torch.equal(out[1], torch.zeros(2))


def test_ab_script_runs_on_cpu(capsys):
    records = ab_fast_decoder.main(["--tiny", "--device", "cpu", "-b", "1", "-n", "1"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("B=1 ")]
    assert [r["dequant"] for r in records] == list(tfast.DEQUANT_MODES)
    assert len(lines) == len(tfast.DEQUANT_MODES)
    for line, rec in zip(lines, records):
        assert f"dequant={rec['dequant']}" in line and "ms/frame" in line
        assert rec["ms_per_frame"] > 0 and rec["aggregate_frames_per_s"] > 0


def plain_traced(tp, args):
    """The plain "s8" call on ``args`` with its rows, and a kernel trace
    equal to them: (codes, logits, plain rows, trace rows, trace scales)."""
    with testing.s8_plain_trace() as rows:
        codes, logits = port(tp, args, "s8")
    layout = tfast.s8_trace_layout(T_CFG)
    at = {key: i for i, key in enumerate(tfast.s8_trace_layout(T_CFG, kernel=False))}
    B = codes.shape[0]
    trace = torch.zeros((len(layout), B, tfast.s8_trace_width(T_CFG)), dtype=torch.int8)
    scales = torch.zeros((len(layout), B))
    for t, key in enumerate(layout):
        q, sc = rows[at[key]]
        trace[t, :, :q.shape[1]] = torch.round(q).to(torch.int8)
        scales[t] = sc[:, 0]
    return codes, logits, rows, trace, scales


def test_s8_plain_trace_follows_the_layout(qparams):
    _, tp = qparams
    args = inputs("numpy B=3")
    with testing.s8_plain_trace() as rows:
        port(tp, args, "s8")
    plain = tfast.s8_trace_layout(T_CFG, kernel=False)
    kernel = tfast.s8_trace_layout(T_CFG)
    widths = {"wqkv": T_CFG.fast_dim, "wo": T_CFG.fast_n_head * T_CFG.fast_head_dim,
              "w13": T_CFG.fast_dim, "w2": T_CFG.fast_intermediate_size,
              "head": T_CFG.fast_dim}
    assert len(rows) == len(plain) == len(kernel) + 3
    assert set(kernel) <= set(plain)
    for (q, sc), (_, _, kind) in zip(rows, plain):
        assert q.shape == (3, widths[kind]) and sc.shape == (3, 1)
        assert float(torch.round(q).abs().max()) == 127.0  # the row's largest
    assert max(widths.values()) == tfast.s8_trace_width(T_CFG)


# Mutations of a kernel trace equal to the plain rows, at stream 1: a step
# moved at the row's element nearest a tie with later positions changed
# (excused), at its element farthest from one, or by two steps, or with an
# earlier position's logits moved, or an earlier row's scale moved (failures).
MUTATIONS = ["none", "tie step", "far step", "two steps", "early logits", "scale"]


@pytest.mark.parametrize("mutation", MUTATIONS)
def test_s8_margins_excuse_only_a_step_at_a_tie(qparams, mutation):
    _, tp = qparams
    args = inputs("numpy B=3")
    codes, logits, rows, trace, scales = plain_traced(tp, args)
    layout = tfast.s8_trace_layout(T_CFG)
    b, pos = 1, 3
    t = layout.index((pos, 0, "w2"))
    q = rows[tfast.s8_trace_layout(T_CFG, kernel=False).index(layout[t])][0][b]
    dist = ((q - torch.floor(q)) - 0.5).abs()
    j = int(dist.argmax() if mutation == "far step" else dist.argmin())
    tie = float(dist.min()) * 1.5 + 1e-9
    got_codes, got_logits = codes.clone(), logits.clone()
    if mutation != "none" and mutation != "scale":
        up = 1 if float(q[j]) > float(torch.round(q[j])) else -1
        trace[t, b, j] += up * (2 if mutation == "two steps" else 1)
        got_logits[b, pos - 1:] += 0.5  # what the moved step changes
    if mutation == "early logits":
        got_logits[b, pos - 2] += 1e-2
    if mutation == "scale":
        scales[t - 1, b] *= 1 + 1e-3
    tol = S8_TOL * float(logits.abs().max())
    m = testing.s8_decision_margins(T_CFG, got_codes, codes, got_logits, logits,
                                    torch.from_numpy(args[3]), SAMPLING[0], SAMPLING[1], tol,
                                    trace, scales, rows, tie)
    R = K - 1
    if mutation == "none":
        assert not m["failures"] and m["excused"] == 0 and m["compared"] == 3 * R
        assert m["witnesses"] == [] and m["scale_err"] == 0.0
    elif mutation == "tie step":
        assert not m["failures"], m["failures"]
        assert m["excused"] == R - (pos - 1)
        assert m["witnesses"] == [(b, t, (pos, 0, "w2"), 1, float(dist[j]))]
        assert m["compared"] == 2 * R + pos - 1
    else:
        assert len(m["failures"]) == 1 and m["failures"][0].startswith(f"stream {b} ")
