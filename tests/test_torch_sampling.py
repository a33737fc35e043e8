"""The port's plain-route sampler (``engine/sampling.py``) against the JAX
package's ``engine/sampling.py`` on the same numpy logits and the same
Gumbel draws: JAX draws them from per-row keys at the width each mode
consumes, and the port gets those draws.  Tokens must be bit-equal for
``top_k`` of -1 (threshold), 0 (full sort) and 8 (truncated, with and
without ``approx``), on f32 logits and on tie-heavy bf16-valued ones, where
the rank of a tied candidate decides which noise lane it meets."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_tts_tpu.engine import sampling as jsampling
from fish_tts_tpu_torch.engine import sampling as tsampling

B, V, W = 6, 4096, 16
TEMPS = np.array([0.7, 0.7, 1.0, 0.3, 1e-6, 0.9], np.float32)[:, None]
TOP_PS = np.array([0.8, 0.95, 0.5, 1.0, 0.8, 0.999], np.float32)[:, None]
PENALTY = np.array([1.1, 1.3, 1.0, 0.9, 1.1, 1.2], np.float32)[:, None]
PROB_TOL = 1e-6  # post-top-p softmax: f32 sums in another order
# A lane's membership may differ only where the mass at and above it lies
# this close to top_p: XLA and torch sum the 4096 f32 masses in other orders.
MASS_TOL = 1e-6

MODES = {"threshold": (-1, False), "full sort": (0, False), "top_k=8": (8, False),
         "top_k=8 approx": (8, True)}


def make_logits(kind: str, seed: int) -> np.ndarray:
    """(B, V) f32 logits: randn x 3, or the same rounded to bf16 (the
    sampler's input on a bf16 route: thousands of ties), or small integers
    (ties everywhere, the nucleus boundary inside a tie group)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    if kind == "bf16":
        x = torch.from_numpy(x).bfloat16().float().numpy()
    elif kind == "ints":
        x = rng.integers(-4, 5, (B, V)).astype(np.float32)
    return x


def row_keys(seed: int):
    return jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(seed), i))(jnp.arange(B))


def draws(keys, width: int) -> torch.Tensor:
    """The Gumbel draws JAX's ``sample`` makes from per-row ``keys`` at
    ``width`` lanes."""
    g = jax.vmap(lambda k: jax.random.gumbel(k, (width,), jnp.float32))(keys)
    return torch.from_numpy(np.array(g))


def penalty_window(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed + 100)
    prev = rng.integers(0, V, (B, W)).astype(np.int32)
    prev[:, -3:] = 0  # a zero-padded window tail: id 0 is penalized like any other
    prev[:, 1] = prev[:, 0]  # a repeated id
    return prev


def cols():
    return [torch.from_numpy(c) for c in (TEMPS, TOP_PS, PENALTY)]


@pytest.mark.parametrize("kind", ["f32", "bf16", "ints"])
@pytest.mark.parametrize("mode", list(MODES))
def test_sample_matches_jax(mode, kind):
    top_k, approx = MODES[mode]
    logits = make_logits(kind, 1)
    prev = penalty_window(1)
    keys = row_keys(7)
    want = np.asarray(jsampling.sample(
        keys, jnp.asarray(logits), jnp.asarray(TEMPS), jnp.asarray(TOP_PS), jnp.asarray(PENALTY),
        prev_idx=jnp.asarray(prev), top_k=top_k, approx=approx))
    width = tsampling.candidate_width(V, top_k)
    assert width == (top_k if top_k > 0 else V)
    got = tsampling.sample(draws(keys, width), torch.from_numpy(logits), *cols(),
                           prev_idx=torch.from_numpy(prev), top_k=top_k, approx=approx)
    assert got.dtype == torch.int32 and got.shape == (B,)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", list(MODES))
def test_sample_without_penalty_reads_wider_noise_as_its_own(mode):
    """Without a window (the prefill frame) the logits go in as they are;
    noise wider than the candidates is read at its first lanes, so the
    default source's full-width draws serve every mode."""
    top_k, approx = MODES[mode]
    logits = make_logits("bf16", 2)
    keys = row_keys(3)
    want = np.asarray(jsampling.sample(
        keys, jnp.asarray(logits).astype(jnp.bfloat16), jnp.asarray(TEMPS),
        jnp.asarray(TOP_PS), jnp.asarray(PENALTY), top_k=top_k, approx=approx))
    g = draws(keys, tsampling.candidate_width(V, top_k))
    wide = torch.cat([g, torch.full((B, 5), 1e9)], dim=1)
    got = tsampling.sample(wide, torch.from_numpy(logits).bfloat16(), *cols(), top_k=top_k,
                           approx=approx)
    np.testing.assert_array_equal(got.numpy(), want)


def test_repetition_penalty_matches_jax():
    logits = make_logits("f32", 3)
    prev = penalty_window(3)
    want = np.asarray(jsampling.apply_repetition_penalty(
        jnp.asarray(logits), jnp.asarray(prev), jnp.asarray(PENALTY)))
    got = tsampling.apply_repetition_penalty(torch.from_numpy(logits), torch.from_numpy(prev),
                                             torch.from_numpy(PENALTY))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(want, logits)


@pytest.mark.parametrize("kind", ["f32", "ints"])
def test_threshold_mask_matches_jax(kind):
    logits = make_logits(kind, 4)
    want = np.asarray(jsampling.top_p_threshold_mask(jnp.asarray(logits), jnp.asarray(TOP_PS)))
    got = tsampling.top_p_threshold_mask(torch.from_numpy(logits), torch.from_numpy(TOP_PS))
    for b, i in np.argwhere(got.numpy() != want):
        l = logits[b].astype(np.float64)
        p = np.exp(l - l.max())
        mass = p[l >= l[i]].sum() / p.sum()
        assert abs(mass - TOP_PS[b, 0]) <= MASS_TOL, (b, i, mass)
    assert (got.numpy() != want).sum() <= 2
    assert want[3].all() and not want[0].all()  # top_p 1 keeps every lane


def test_probs_exact_matches_jax():
    logits = make_logits("bf16", 5)
    prev = penalty_window(5)
    for b in range(B):
        args = (TEMPS[b, 0], TOP_PS[b, 0], PENALTY[b, 0])
        want = np.asarray(jsampling.logits_to_probs_exact(
            jnp.asarray(logits[b]), *(jnp.float32(a) for a in args), jnp.asarray(prev[b])))
        got = tsampling.logits_to_probs_exact(torch.from_numpy(logits[b]), *args,
                                              torch.from_numpy(prev[b]).long())
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PROB_TOL)
        assert abs(float(got.sum()) - 1.0) < 1e-5
