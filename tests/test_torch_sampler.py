"""The slow-token sampler at the full S1-mini vocabulary, on the CPU.

- The plain version against the JAX package's Pallas kernel in interpret
  mode, on bf16-rounded logits (the main path's input, full of ties) with
  the penalty on the leaders.
- The live-row argument the CUDA kernel rests on (``csrc/sampler.cu``): once
  the bisection has left [lo_j, hi_j), finishing it from A_j = mass{l >=
  hi_j} and the live rows lo_j <= l < hi_j gives the same hi as the
  full-row bisection, at every level j.
- A numpy model of the kernel's schedule (cluster rounds of two levels
  while the live set exceeds its capacity, then the remaining levels on
  the compacted rows) gives the plain version's tokens, and the round
  counts the kernel reports.
- ``testing.slow_decision_margins``: a differing token is excused only at
  a knife edge of the plain version's own numbers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_tts_tpu.ops import sampler_kernel as jsamp
from fish_tts_tpu_torch.ops import sampler_kernel as tsamp
from fish_tts_tpu_torch.testing import slow_decision_margins

V = 155776        # S1-mini vocabulary
CAP = 3072        # csrc/sampler.cu kCap: live rows rank 0 finishes alone
LEVELS = 2        # csrc/sampler.cu kLevels: bisection levels per cluster round
TOL = 1e-6        # a decision's mass this close to top_p is a knife edge
TOP_PS = (0.1, 0.5, 0.8, 0.95, 1.0)
f32 = np.float32


def _bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _row(seed: int, kind: str) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "ints":  # ties keep the live set above CAP
        return rng.integers(-3, 4, V).astype(f32)
    scale = {"bf16": 3.0, "bf16_flat": 1.0}[kind]
    return _bf16((rng.standard_normal(V) * scale).astype(f32))


def _softmax(l: np.ndarray) -> tuple[np.float32, np.ndarray]:
    amax = l.max()
    z = f32(np.log(np.exp(l - amax).sum(dtype=f32))) + amax
    return amax, np.exp(l - z).astype(f32)


def _bisect(l, p, tp, lo, hi, A, levels, live=None):
    """Finish ``levels`` bisection levels from [lo, hi) with A = mass{l >=
    hi}, summing only the rows in ``live``.  Returns (lo, hi, masses)."""
    if live is not None:
        l, p = l[live], p[live]
    masses = []
    for _ in range(levels):
        mid = f32(0.5) * f32(lo + hi)
        mass = f32(A + p[(l >= mid) & (l < hi)].sum(dtype=f32))
        masses.append(mass)
        if mass <= tp:
            hi, A = mid, mass
        else:
            lo = mid
    return lo, hi, masses


# --- the plain version against the Pallas kernel ------------------------------


def test_plain_matches_pallas_full_vocab():
    B, W = 2, 11
    rng = np.random.default_rng(5)
    logits = _bf16((rng.standard_normal((B, V)) * 3).astype(f32))
    prev = rng.integers(0, V, (B, W)).astype(np.int32)
    prev[:, :3] = np.argsort(-logits, axis=1)[:, :3]  # penalize the leaders
    t, p, r = 0.7, 0.8, 1.1
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(7), i))(jnp.arange(B))
    gumbel = jax.jit(jax.vmap(lambda k: jax.random.gumbel(k, (V,), jnp.float32)))(keys)
    want = jsamp.sample_slow(keys, jnp.asarray(logits), jnp.asarray(prev), jnp.float32(t),
                             jnp.float32(p), jnp.float32(r), vocab=V, interpret=True)
    col = [torch.full((B, 1), v) for v in (t, p, r)]
    got = tsamp.sample_slow(torch.from_numpy(logits), torch.from_numpy(prev),
                            torch.from_numpy(np.array(gumbel)), *col)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- the live-row argument ------------------------------------------------------------


@pytest.mark.parametrize("tp", TOP_PS)
@pytest.mark.parametrize("kind,seed", [("bf16", 0), ("bf16_flat", 1)])
def test_live_rows_finish_the_bisection(kind, seed, tp):
    l = _row(seed, kind)
    amax, p = _softmax(l)
    tp = f32(tp)
    lo, hi = f32(amax - f32(30)), f32(amax + f32(1))
    # the full-row bisection, with (lo_j, hi_j) before each level j
    states, masses = [], []
    for _ in range(tsamp.BISECT_ITERS):
        states.append((lo, hi))
        mid = f32(0.5) * f32(lo + hi)
        mass = p[l >= mid].sum(dtype=f32)
        masses.append(mass)
        if mass <= tp:
            hi = mid
        else:
            lo = mid
    hi_full = hi
    edges = 0
    for j, (lo_j, hi_j) in enumerate(states):
        A_j = p[l >= hi_j].sum(dtype=f32)
        live = (l >= lo_j) & (l < hi_j)
        _, hi_live, m_live = _bisect(l, p, tp, lo_j, hi_j, A_j, tsamp.BISECT_ITERS - j, live)
        if hi_live != hi_full:
            near = [abs(float(m) - float(tp)) <= TOL for m in masses[j:] + m_live]
            assert any(near), (j, hi_live, hi_full)
            edges += 1
    assert edges == 0


# --- the kernel's schedule -------------------------------------------------------------


def _kernel_schedule(l, tp):
    """The threshold of ``csrc/sampler.cu`` for one penalized row, in numpy:
    (thresh, cluster rounds, live rows at compaction or -1)."""
    if tp >= 1.0:
        return f32(0.5 * tsamp.NEG), 0, -1
    amax, p = _softmax(l)
    lo, hi = f32(amax - f32(30)), f32(amax + f32(1))
    A = p[l >= hi].sum(dtype=f32)
    live = (l >= lo) & (l < hi)
    level = rounds = 0
    while level < tsamp.BISECT_ITERS:
        # one round: the three mids of the next two levels summed at once,
        # each mass A of the round's start plus the live rows above its mid
        m0 = f32(0.5) * f32(lo + hi)
        mids = (f32(0.5) * f32(lo + m0), m0, f32(0.5) * f32(m0 + hi))
        S = [p[live & (l >= m)].sum(dtype=f32) for m in mids]
        j, A_next = 1, A
        for step in (1, 0):
            mass = f32(A + S[j])
            if mass <= tp:
                hi, A_next, j = mids[j], mass, j - step
            else:
                lo, j = mids[j], j + step
        A = A_next
        live &= (l >= lo) & (l < hi)
        level += LEVELS
        rounds += 1
        if live.sum() <= CAP:
            break
    live_at = -1
    if level < tsamp.BISECT_ITERS:
        live_at = int(live.sum())
        lo, hi, _ = _bisect(l, p, tp, lo, hi, A, tsamp.BISECT_ITERS - level, live)
    return min(hi, amax), rounds, live_at


@pytest.mark.parametrize("kind,seed", [("bf16", 2), ("bf16_flat", 3), ("ints", 4)])
def test_kernel_schedule_gives_plain_tokens(kind, seed):
    B, W = len(TOP_PS), 11
    rng = np.random.default_rng(seed)
    logits = np.stack([_row(seed, kind)] * B)
    prev = rng.integers(0, V, (B, W)).astype(np.int32)
    prev[:, :3] = np.argsort(-logits[0])[:3]
    gumbel = -np.log(-np.log(rng.uniform(1e-6, 1.0, (B, V)))).astype(f32)
    t, r = 0.7, 1.1
    tps = torch.tensor(TOP_PS, dtype=torch.float32)[:, None]
    args = (torch.from_numpy(logits), torch.from_numpy(prev), torch.from_numpy(gumbel),
            torch.full((B, 1), t), tps, torch.full((B, 1), r))
    want = tsamp.sample_slow_plain(*args)
    hit = np.zeros((B, V), bool)
    np.put_along_axis(hit, prev.astype(np.int64), True, axis=1)
    pen = np.where(hit, np.where(logits < 0, logits * f32(r), logits / f32(r)), logits)
    got, stats = [], []
    for b, tp in enumerate(TOP_PS):
        thresh, rounds, live_at = _kernel_schedule(pen[b].astype(f32), f32(tp))
        masked = np.where(pen[b] >= thresh, pen[b], f32(tsamp.NEG)).astype(f32)
        got.append(int(np.argmax(masked / f32(t) + gumbel[b])))
        stats.append((rounds, live_at))
        assert rounds <= tsamp.BISECT_ITERS // LEVELS
        if tp >= 1.0:
            assert (rounds, live_at) == (0, -1)
        elif kind == "ints":  # every level on cluster rounds
            assert (rounds, live_at) == (tsamp.BISECT_ITERS // LEVELS, -1), stats
        else:
            assert 0 <= live_at <= CAP and rounds < tsamp.BISECT_ITERS // LEVELS, stats
    m = slow_decision_margins(torch.tensor(got, dtype=torch.int32), want, *args)
    assert m["failures"] == [] and m["knife_edges"] == 0, (m, stats)


# --- the margin check -------------------------------------------------------------------


def _margin_case(name):
    """One row of 8 lanes: (kernel token, plain token, args, expected
    (knife edges, failures))."""
    l = torch.tensor([[2.0, 1.0, 0.5, 0.3, 0.2, 0.1, 0.0, -1.0]])
    g = torch.zeros_like(l)
    prev = torch.full((1, 1), 7, dtype=torch.int32)
    t, r = torch.full((1, 1), 1.0), torch.full((1, 1), 1.0)
    tp = torch.full((1, 1), 1.0)
    if name == "near_tie":  # lane 1's perturbed value 5e-7 above lane 0's
        g[0, 1] = 1.0 + 5e-7
        want = (1, 0)
    elif name == "clear":
        g[0, 1] = 1.5
        want = (0, 1)
    else:  # the mass of {lane 0} sits 5e-7 from top_p
        p0 = float(torch.softmax(l.double(), dim=-1)[0, 0])
        tp = torch.full((1, 1), p0 + 5e-7)
        g[0, 1] = 5.0
        want = (1, 0)
    args = (l, prev, g, t, tp, r)
    plain = tsamp.sample_slow_plain(*args)
    other = torch.tensor([0 if int(plain[0]) != 0 else 1], dtype=torch.int32)
    return other, plain, args, want


@pytest.mark.parametrize("name", ["near_tie", "clear", "mass_edge"])
def test_slow_decision_margins(name):
    got, plain, args, want = _margin_case(name)
    out = slow_decision_margins(got, plain, *args)
    assert (out["knife_edges"], len(out["failures"])) == want, out
    assert slow_decision_margins(plain, plain, *args)["knife_edges"] == 0
