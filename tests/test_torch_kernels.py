"""The plain PyTorch versions of the port's three kernels against the JAX
package's Pallas kernels run in interpret mode, at tiny size.

- sampler: tokens equal, row for row;
- slow stack: hidden, new K/V and logits within 2e-3 rtol / 5e-3 atol, the
  JAX suite's own kernel tolerance (tests/test_slow_stack.py);
- fast decoder: codes equal, penalized logits within the same tolerance.

On CPU tensors each wrapper runs its plain version and launches nothing.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_tts_tpu.config import TINY_CONFIG
from fish_tts_tpu.models import dual_ar as jdual
from fish_tts_tpu.ops import fast_decoder as jfast
from fish_tts_tpu.ops import sampler_kernel as jsamp
from fish_tts_tpu.ops import slow_stack as jslow
from fish_tts_tpu.utils.quantize import quantize_lm_params
from fish_tts_tpu_torch.config import TINY_CONFIG as T_TINY_CONFIG
from fish_tts_tpu_torch.models import dual_ar as tdual
from fish_tts_tpu_torch.ops import fast_decoder as tfast
from fish_tts_tpu_torch.ops import sampler_kernel as tsamp
from fish_tts_tpu_torch.ops import slow_stack as tslow
from fish_tts_tpu_torch.utils import checkpoint as tckpt

RTOL, ATOL = 2e-3, 5e-3  # tests/test_slow_stack.py's kernel tolerance


def _col(x, B):
    return torch.full((B, 1), float(x))


@pytest.fixture(scope="module")
def qparams():
    """int8 tiny params (max_seq_len 1024, so the JAX slow-stack kernel
    streams the cache in several blocks): (jax params, port params)."""
    params = jdual.init_params(jax.random.PRNGKey(0), TINY_CONFIG, jnp.float32)
    jp = quantize_lm_params(params)
    tp = tckpt.from_jax_params(jax.tree_util.tree_map(np.asarray, jp))
    return jp, tp


# --- kernel 1: sampler -----------------------------------------------------------


@pytest.mark.parametrize("case", ["random", "ties", "top_p_one", "penalty_on_zero"])
def test_sampler_plain_matches_pallas(case):
    B, V = 4, 640
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((B, V)) * 4).astype(np.float32)
    prev = rng.integers(0, V, (B, 11)).astype(np.int32)
    t, p, r = 0.7, 0.8, 1.1
    if case == "ties":
        logits = rng.integers(-3, 4, (B, V)).astype(np.float32)
    elif case == "top_p_one":
        p, r = 1.0, 1.0
    elif case == "penalty_on_zero":
        logits[:, 0] = logits.max(axis=1) + 0.05  # id 0 leads, then is penalized
        prev[:, :6] = 0
        r = 1.9
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(11), i))(jnp.arange(B))
    gumbel = jax.jit(jax.vmap(lambda k: jax.random.gumbel(k, (V,), jnp.float32)))(keys)
    want = jsamp.sample_slow(keys, jnp.asarray(logits), jnp.asarray(prev), jnp.float32(t),
                             jnp.float32(p), jnp.float32(r), vocab=V, interpret=True)
    before = tsamp.launches
    got = tsamp.sample_slow(torch.from_numpy(logits), torch.from_numpy(prev),
                            torch.from_numpy(np.array(gumbel)), _col(t, B), _col(p, B),
                            _col(r, B))
    assert tsamp.launches == before  # CPU tensors: plain version, no launch
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- kernel 2: slow stack ----------------------------------------------------------


@pytest.mark.parametrize("pos", [[700], [700, 13, 1000]], ids=["B1", "B3"])
def test_slow_stack_plain_matches_pallas(qparams, pos):
    jcfg = dataclasses.replace(TINY_CONFIG, max_seq_len=1024)
    tcfg = dataclasses.replace(T_TINY_CONFIG, max_seq_len=1024)
    jp, tp = qparams
    B, R = len(pos), 1024
    assert R > jslow._rb_size(R, B)  # the Pallas kernel streams several blocks
    rng = np.random.default_rng(4)
    shape = (tcfg.n_layer, B, tcfg.n_local_heads, tcfg.max_seq_len, tcfg.head_dim)
    kc = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    vc = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    x = rng.standard_normal((B, tcfg.dim)).astype(np.float32)
    pos = np.asarray(pos, np.int32)
    jrope = jdual.make_rope_tables(jcfg)["slow"]
    trope = tdual.make_rope_tables(tcfg)["slow"]
    np.testing.assert_array_equal(trope.float().numpy(), np.asarray(jrope, np.float32))

    want = jslow.slow_stack_step(
        jslow.prepare_head(jp, jcfg), jcfg, jrope, jnp.asarray(x),
        {"k": jnp.asarray(kc), "v": jnp.asarray(vc)}, jnp.asarray(pos),
        read_len=R, interpret=True)
    got = tslow.slow_stack_step(
        tp, tcfg, trope, torch.from_numpy(x),
        {"k": torch.from_numpy(kc), "v": torch.from_numpy(vc)}, torch.from_numpy(pos),
        read_len=R)
    for name, w, g in zip(("hidden", "new_k", "new_v", "logits"), want, got):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL, err_msg=name)


# --- kernel 3: fast decoder -----------------------------------------------------------


@pytest.mark.parametrize("B,t,p,r", [(1, 0.7, 0.8, 1.1), (3, 0.9, 0.6, 1.3),
                                     (2, 0.7, 1.0, 1.0)],
                         ids=["B1", "B3", "top_p_one"])
def test_fast_decoder_plain_matches_pallas(qparams, B, t, p, r):
    cfg = T_TINY_CONFIG
    jp, tp = qparams
    K, Vr, W = cfg.num_codebooks, cfg.residual_codebook_size, 16
    rng = np.random.default_rng(5 + B)
    h = rng.standard_normal((B, cfg.fast_dim)).astype(np.float32)
    a0 = rng.integers(0, cfg.codebook_size, B).astype(np.int32)
    prev = rng.integers(0, Vr, (B, K - 1, W)).astype(np.int32)
    gumbel = rng.gumbel(size=(B, K - 1, Vr)).astype(np.float32)
    rope = jdual.make_rope_tables(TINY_CONFIG)["fast"]
    codes_w, logits_w = jfast.fast_decode_frame(
        jp, TINY_CONFIG, rope, jnp.asarray(h), jnp.asarray(a0), jnp.asarray(prev),
        jnp.asarray(gumbel), jnp.float32(t), jnp.float32(p), jnp.float32(r),
        window=W, interpret=True)
    codes, logits = tfast.fast_decode_frame(
        tp, cfg, tdual.make_rope_tables(cfg)["fast"], torch.from_numpy(h),
        torch.from_numpy(a0), torch.from_numpy(prev), torch.from_numpy(gumbel),
        t, p, r, window=W)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(codes_w))
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_w), rtol=RTOL, atol=ATOL)


# --- the wrappers' input checks ------------------------------------------------------


@pytest.mark.parametrize("case", ["dtype", "shape", "contiguity", "device"])
def test_require_cuda_rejects(case):
    """The launch path refuses what the kernels do not take."""
    from fish_tts_tpu_torch.ops import kernels

    t = torch.zeros((4, 6), dtype=torch.float32)
    args, want = {
        "dtype": ((t, torch.int32), "expected torch.int32"),
        "shape": ((t, torch.float32, (6, 4)), "expected shape"),
        "contiguity": ((t.t(), torch.float32), "contiguous"),
        "device": ((t, torch.float32, (4, 6)), "CUDA tensor"),
    }[case]
    with pytest.raises(ValueError, match=want):
        kernels.require_cuda("t", *args)


def test_check_block_dims():
    from fish_tts_tpu_torch.ops import kernels

    kernels.check_block_dims("s1", 1024, 16, 8, 64, 4096)
    kernels.check_block_dims("tiny", 64, 4, 2, 16, 128)
    for dims in ((1000, 16, 8, 64, 4096), (1024, 16, 8, 64, 4100), (1024, 2, 1, 130, 4096),
                 (1024, 16, 1, 64, 4096), (1024, 16, 8, 63, 4096)):
        with pytest.raises(ValueError):
            kernels.check_block_dims("bad", *dims)
