"""The port's decode routes against the JAX package's, at tiny size: every
row of the routes table (precision, engine options, attention biases,
qk-norm, an untied head, B above the kernels' limit) as the port's
``prefill`` + ``decode_chunk`` against JAX's ``prefill_chunk`` +
``decode_chunk`` with the matching ``fast_kernel``/``top_k``/``approx``
(Pallas in interpret mode).

Both packages take the same weights, made from a seed, with the attention
biases and qk-norm gains randomized by numpy (JAX's ``init_params`` makes
them zeros and ones, and a dropped zero bias would show nothing).  The port
gets a host noise source that replays the JAX route's draws: one key per
(slot, step), split into a slow and a fast key; the slow token's draw at
the width its sampler reads, the residual books' as one (K-1, Vr) block on
the fast-decoder kernel and from one key per book on the plain loop.
Frames, emitted flags and the integer state must be equal; the KV cache
agrees within the precision's tolerance (the prefill runs in XLA on one side
and in PyTorch on the other).  The logits of the slow and fast stacks are
held against JAX's on the same inputs within 1e-5 relative (fp32, and int8
over f32) and 2e-2 (bf16, fp16: one rounding step apart in a few elements).

The reference's fast-decoder kernel ignores the fast stack's attention
biases and qk-norm (its gate never asks); the port's gate refuses them.  So
the fast-flag config is held against JAX with its fast-decoder gate refused
(its slow-stack and sampler kernels kept, as in the port) and against JAX's
``fast_kernel=False`` route.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_tts_tpu.config import TINY_CONFIG
from fish_tts_tpu.engine import decode as jdecode
from fish_tts_tpu.models import dual_ar as jdual
from fish_tts_tpu.models.prompt import build_prompt as jbuild_prompt
from fish_tts_tpu.models.tokenizer import FishTokenizer as JTokenizer
from fish_tts_tpu.models.tokenizer import tiny_special_tokens, write_tiny_vocab
from fish_tts_tpu.ops import fast_decoder as jfast
from fish_tts_tpu.ops import sampler_kernel as jsampler
from fish_tts_tpu.ops import slow_stack as jslow
from fish_tts_tpu.utils.quantize import quantize_lm_params
from fish_tts_tpu_torch import testing
from fish_tts_tpu_torch.config import TINY_CONFIG as T_CFG
from fish_tts_tpu_torch.engine import decode as tdecode
from fish_tts_tpu_torch.engine import sampling as tsampling
from fish_tts_tpu_torch.models import dual_ar as tdual
from fish_tts_tpu_torch.utils import checkpoint as tckpt
from test_torch_stream import one_thread  # noqa: F401 (an autouse fixture)

TEXTS = ("Hello world, this is a test.", "A second, shorter one.")
SAMPLING = (0.7, 0.8, 1.1)
N = 12  # decode frames after the prefill frame
KV_BUCKET = 128
BASE_KEY = jax.random.PRNGKey(0)
# Relative tolerance of logits and of the KV cache, against the largest
# magnitude.  fp32 and int8 over f32 weights: f32 sums in another order (the
# int8 kernels' plain versions round activations to bf16 on both sides
# alike); bf16 and fp16: an activation that rounds to the other neighbour.
TOL = {"fp32": 1e-5, "int8": 1e-5, "bf16": 2e-2, "fp16": 2e-2}
# The KV cache after prefill and N frames: in int8 over f32 a prefill that
# differs in the last f32 bit can round a kernel activation to the other
# bf16 neighbour (the slice test's KV_TOL).
KV_TOL = {"fp32": 1e-5, "int8": 1e-4, "bf16": 2e-2, "fp16": 2e-2}
DTYPES = {"fp32": jnp.float32, "bf16": jnp.bfloat16, "fp16": jnp.float16}

SLOW_FLAGS = dict(attention_qkv_bias=True, attention_o_bias=True, attention_qk_norm=True,
                  fast_attention_qkv_bias=False, fast_attention_o_bias=False,
                  fast_attention_qk_norm=False)
FAST_FLAGS = dict(fast_attention_qkv_bias=True, fast_attention_o_bias=True,
                  fast_attention_qk_norm=True)
# both stacks: a replaced config keeps the fast flags its source resolved
ALL_FLAGS = dict(SLOW_FLAGS, **FAST_FLAGS)


@dataclasses.dataclass(frozen=True)
class Row:
    precision: str
    overrides: tuple = ()
    top_k: int = -1
    approx: bool = False
    fast_kernel: bool = True
    batch: int = 2
    route: tuple = (True, True, True)  # slow stack, sampler, fast decoder on their kernels
    refuse_jax_fast_gate: bool = False


ROWS = {
    "int8": Row("int8"),
    "int8 untied head": Row("int8", (("tie_word_embeddings", False),)),
    "int8 top_k=0": Row("int8", top_k=0, route=(True, False, True)),
    "int8 top_k=8": Row("int8", top_k=8, route=(True, False, False)),
    "int8 top_k=8 approx": Row("int8", top_k=8, approx=True, route=(True, False, False)),
    "int8 slow flags": Row("int8", tuple(SLOW_FLAGS.items()), route=(False, True, True)),
    "int8 fast flags": Row("int8", tuple(FAST_FLAGS.items()), route=(True, True, False),
                           refuse_jax_fast_gate=True),
    "int8 fast flags, fast_kernel=False": Row("int8", tuple(FAST_FLAGS.items()),
                                              fast_kernel=False, route=(False, False, False)),
    "int8 fast_kernel=False": Row("int8", fast_kernel=False, route=(False, False, False)),
    "int8 B=17": Row("int8", batch=17, route=(False, False, False)),
    "bf16": Row("bf16", route=(False, True, False)),
    "bf16 flags": Row("bf16", tuple(ALL_FLAGS.items()), route=(False, True, False)),
    "bf16 top_k=8": Row("bf16", top_k=8, route=(False, False, False)),
    "fp16": Row("fp16", route=(False, True, False)),
    "fp32": Row("fp32", route=(False, True, False)),
    "fp32 untied head, top_k=0": Row("fp32", (("tie_word_embeddings", False),), top_k=0,
                                     route=(False, False, False)),
}


def randomize_extras(params, seed: int):
    """Attention biases and qk-norm gains drawn by numpy, in place of the
    zeros and ones of ``init_params``."""
    rng = np.random.default_rng(seed)
    out = dict(params)
    for stack in ("layers", "fast_layers"):
        st = dict(out[stack])
        for k, scale, base in (("wqkv_b", 0.1, 0.0), ("wo_b", 0.05, 0.0),
                               ("q_norm", 0.3, 1.0), ("k_norm", 0.3, 1.0)):
            if k in st:
                st[k] = jnp.asarray(base + scale * rng.standard_normal(st[k].shape),
                                    st[k].dtype)
        out[stack] = st
    return out


@functools.cache
def tokenizer_and_prompt(batch: int):
    import tempfile
    from pathlib import Path

    path = Path(tempfile.mkdtemp()) / "tokenizer.tiktoken"
    write_tiny_vocab(path)
    tok = JTokenizer(path, tiny_special_tokens(TINY_CONFIG.codebook_size))
    ids = jdual.TokenIds(tok.semantic_begin_id, tok.semantic_end_id, tok.im_end_id)
    encs = [jbuild_prompt(tok, TEXTS[b % 2], TINY_CONFIG.num_codebooks).values
            for b in range(batch)]
    prompt = np.zeros((batch, 1 + TINY_CONFIG.num_codebooks, 64), np.int32)
    for b, enc in enumerate(encs):
        prompt[b, :, :enc.shape[1]] = enc
    return ids, prompt, np.array([e.shape[1] for e in encs], np.int32)


def make_params(precision: str, overrides: tuple, seed: int = 0):
    """(JAX config, JAX params, port config, port params) at ``precision``:
    a float dtype, or int8 weights over f32 (as the other port tests)."""
    jcfg = dataclasses.replace(TINY_CONFIG, **dict(overrides))
    tcfg = dataclasses.replace(T_CFG, **dict(overrides))
    jp = randomize_extras(jdual.init_params(jax.random.PRNGKey(seed), jcfg, jnp.float32), seed)
    jp = quantize_lm_params(jp) if precision == "int8" else jdual.cast_params(
        jp, DTYPES[precision])
    tp = tckpt.from_jax_params(jax.tree_util.tree_map(np.asarray, jp))
    return jcfg, jp, tcfg, tp


def replay_noise(key, cfg):
    """A host source replaying the JAX route's draws for base ``key``."""
    K, Vr = cfg.num_codebooks, cfg.residual_codebook_size

    @functools.partial(jax.jit, static_argnums=(2, 3, 4))
    def draw(slot, step, slow, fast, per_book):
        ks, kf = jax.random.split(jax.random.fold_in(jax.random.fold_in(key, slot), step))
        g_slow = jax.random.gumbel(ks, (slow,), jnp.float32)
        if per_book:  # the plain loop: one key per book
            g_fast = jax.vmap(lambda k: jax.random.gumbel(k, (fast,), jnp.float32))(
                jax.random.split(kf, K - 1))
        else:  # the fast-decoder kernel: one block
            g_fast = jax.random.gumbel(kf, (K - 1, Vr), jnp.float32)
        return g_slow, g_fast

    def noise(slot, step, d: tdecode.Draws):
        g_slow, g_fast = draw(jnp.uint32(slot), jnp.uint32(step), d.slow, d.fast, d.per_book)
        return torch.from_numpy(np.array(g_slow)), torch.from_numpy(np.array(g_fast))

    return noise


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def jax_route(row: Row, jcfg, jp) -> tuple:
    """The JAX package's gates for the row (its fast-decoder gate as the
    row runs it)."""
    B, R = row.batch, KV_BUCKET
    fk = row.fast_kernel
    return (fk and jslow.supports(jcfg, jp, B) and jslow.fits(jcfg, B, R),
            fk and jsampler.supports(B, row.top_k),
            fk and row.top_k <= 0 and not row.refuse_jax_fast_gate
            and jfast.supports(jcfg, jp, B))


class Decisions:
    """The port's sampling decisions of one call, in order: the slow token,
    then each residual book, as (top_k, penalized logits (B, n), noise as
    read (B, n), temperature, top_p, picks (B,)), whatever route made them."""

    def __init__(self, monkeypatch):
        self.calls = []
        sample, slow, fast = (tdecode.sample, tdecode.sampler_kernel.sample_slow,
                              tdecode.fast_decoder.fast_decode_frame)

        def rec_sample(gumbel, logits, temperature, top_p, rep, prev_idx=None, top_k=0,
                       approx=False):
            out = sample(gumbel, logits, temperature, top_p, rep, prev_idx, top_k=top_k,
                         approx=approx)
            pen = logits.float()
            if prev_idx is not None:
                pen = tsampling.apply_repetition_penalty(pen, prev_idx, rep)
            self.calls.append((top_k, pen, gumbel, temperature, top_p, out))
            return out

        def rec_slow(logits, prev_col, gumbel, temperature, top_p, rep, skip=None):
            out = slow(logits, prev_col, gumbel, temperature, top_p, rep, skip)
            pen = tsampling.apply_repetition_penalty(logits, prev_col, rep)
            self.calls.append((-1, pen, gumbel, temperature, top_p, out))
            return out

        def rec_fast(*a, **k):
            codes, logits = fast(*a, **k)
            gumbel, temperature, top_p = a[6:9]
            for i in range(codes.shape[1]):
                self.calls.append((-1, logits[:, i], gumbel[:, i], temperature, top_p,
                                   codes[:, i]))
            return codes, logits

        monkeypatch.setattr(tdecode, "sample", rec_sample)
        monkeypatch.setattr(tdecode.sampler_kernel, "sample_slow", rec_slow)
        monkeypatch.setattr(tdecode.fast_decoder, "fast_decode_frame", rec_fast)

    def hold(self, frames: np.ndarray, want: np.ndarray, tol: float) -> int:
        """Hold the port's frames (B, 1+K) against JAX's from the same state:
        per stream, the first differing code must sit on a knife edge of the
        port's own decision (``testing.sample_decision_margins``, logits
        that may each move by ``tol`` of their largest magnitude).  Returns
        the knife edges met; clears the record."""
        calls, self.calls = self.calls, []
        edges = 0
        for b in np.flatnonzero((frames != want).any(axis=1)):
            j = int(np.flatnonzero(frames[b] != want[b])[0])
            assert j != 1, "the first code follows the slow token"
            top_k, logits, gumbel, temperature, top_p, picks = calls[0 if j == 0 else j - 1]
            assert int(picks[b]) == frames[b, j]
            m = testing.sample_decision_margins(
                torch.tensor([want[b, j]]), picks[b:b + 1], logits[b:b + 1], gumbel[b:b + 1],
                temperature[b:b + 1], top_p[b:b + 1], top_k,
                tol * float(logits[b].abs().max()))
            assert not m["failures"], (b, j, m["failures"])
            edges += m["knife_edges"]
        return edges


def to_jax_state(state, dtype):
    out = {k: jnp.asarray(state[k].numpy()) for k in ("frame", "pos", "prev", "step", "done")}
    out["kv"] = {k: jnp.asarray(v.float().numpy()).astype(dtype) for k, v in state["kv"].items()}
    return out


def hold_state(state, jstate, tol: float, ints: bool) -> None:
    """The port's state against JAX's after the same frame: the KV cache
    within ``tol`` of its largest magnitude; with ``ints`` (equal frames)
    the integer state equal."""
    for k in ("k", "v"):
        err = rel(state["kv"][k].float().numpy(), np.asarray(jstate["kv"][k], np.float32))
        assert err <= tol, (k, err)
    if ints:
        for k in ("step", "pos", "prev", "frame", "done"):
            np.testing.assert_array_equal(state[k].numpy(), np.asarray(jstate[k]), err_msg=k)


@pytest.mark.parametrize("name", list(ROWS))
def test_route_matches_jax(name, monkeypatch):
    """The row's route in both packages, then the prefill frame and N decode
    frames, each from the port's state on both sides (so that a frame which
    met a knife edge does not carry into the next): frames equal but at
    knife edges of the port's own decisions (at most a quarter of them),
    emitted flags equal, the state as ``hold_state`` says."""
    row = ROWS[name]
    B = row.batch
    jcfg, jp, tcfg, tp = make_params(row.precision, row.overrides)
    ids, prompt, lengths = tokenizer_and_prompt(B)
    opts = dict(top_k=row.top_k, approx=row.approx, fast_kernel=row.fast_kernel)
    jopts = dict(cfg=jcfg, ids=ids, top_k=row.top_k, approx=row.approx,
                 fast_kernel=row.fast_kernel)

    # the port's gates give the row's route, and so do the JAX package's
    got = tdecode.route(tcfg, tp, B, tdecode.WINDOW, **opts)
    assert (got.slow_stack, got.sampler, got.fast) == row.route
    if row.refuse_jax_fast_gate:
        assert jfast.supports(jcfg, jp, B)  # the reference's fault: its gate takes them
        monkeypatch.setattr(jfast, "supports", lambda *a, **k: False)
    assert jax_route(row, jcfg, jp) == row.route

    jk = jslow.prepare_head(jp, jcfg)
    rope, trope = jdual.make_rope_tables(jcfg), tdual.make_rope_tables(tcfg)
    t, p, r = (jnp.float32(v) for v in SAMPLING)
    noise = replay_noise(BASE_KEY, tcfg)
    seen = Decisions(monkeypatch)
    dtype = jp["norm"].dtype
    tol, kv_tol = TOL[row.precision], KV_TOL[row.precision]

    jstate, jf0, _ = jdecode.prefill_chunk(
        jk, rope, jdecode.init_state(jk, jcfg, batch=B), jnp.asarray(prompt),
        jnp.asarray(lengths), BASE_KEY, t, p, r, num_frames=0, kv_bucket_prefill=0,
        kv_bucket=KV_BUCKET, **jopts)
    state = tdecode.init_state(tp, tcfg, batch=B)
    state, first = tdecode.prefill(
        tp, trope, state, torch.from_numpy(prompt), torch.from_numpy(lengths), noise,
        *SAMPLING, cfg=tcfg, ids=ids, kv_bucket=0, **opts)
    edges = seen.hold(first.numpy(), np.asarray(jf0)[:, 0], tol)
    hold_state(state, jstate, kv_tol, ints=not edges)

    frames = [first.numpy()]
    for _ in range(N):
        jstate, jf, je = jdecode.decode_chunk(
            jk, rope, to_jax_state(state, dtype), BASE_KEY, t, p, r, num_frames=1,
            kv_bucket=KV_BUCKET, early_exit=True, **jopts)
        state, f, e = tdecode.decode_chunk(
            tp, trope, state, noise, *SAMPLING, cfg=tcfg, ids=ids, num_frames=1,
            kv_bucket=KV_BUCKET, early_exit=True, **opts)
        np.testing.assert_array_equal(e.numpy(), np.asarray(je))
        n = seen.hold(f[:, 0].numpy(), np.asarray(jf)[:, 0], tol)
        hold_state(state, jstate, kv_tol, ints=not n)
        edges += n
        frames.append(f[:, 0].numpy())
    assert edges <= (N + 1) * B // 4, f"{edges} knife edges in {(N + 1) * B} frames"
    assert len(set(np.stack(frames)[:, :, 0].flatten().tolist())) > 3  # not degenerate


FORWARD_CASES = {
    "fp32": ("fp32", ()), "fp32 flags": ("fp32", tuple(ALL_FLAGS.items())),
    "fp32 untied head": ("fp32", (("tie_word_embeddings", False),)),
    "bf16 flags": ("bf16", tuple(ALL_FLAGS.items())), "fp16 flags": ("fp16", tuple(ALL_FLAGS.items())),
    "int8 flags": ("int8", tuple(ALL_FLAGS.items())),
}


@pytest.mark.parametrize("name", list(FORWARD_CASES))
def test_forward_logits_match_jax(name):
    """The slow stack over a prompt (``slow_forward`` + ``lm_logits``) and
    the fast stack over every codebook position (``fast_step``) give JAX's
    logits on the same inputs, within the precision's tolerance."""
    precision, overrides = FORWARD_CASES[name]
    jcfg, jp, tcfg, tp = make_params(precision, overrides, seed=3)
    ids, prompt, lengths = tokenizer_and_prompt(2)
    T = prompt.shape[-1]
    positions = np.broadcast_to(np.arange(T, dtype=np.int32), (2, T))
    t_idx = np.arange(T)
    block = np.where(t_idx[None, :] <= t_idx[:, None], 0.0, np.finfo(np.float32).min)
    block = block[None, None].astype(np.float32)
    jkv = jdual.init_kv_cache(jcfg, 2, dtype=jp["norm"].dtype)
    jh, _ = jdual.slow_forward(jp, jcfg, ids, jdual.make_rope_tables(jcfg), jnp.asarray(prompt),
                               jnp.asarray(positions), jkv, None, jnp.asarray(block),
                               read_len=0)
    jl = jdual.lm_logits(jp, jcfg, jh)
    tkv = tdual.init_kv_cache(tcfg, 2, dtype=tp["norm"].dtype)
    trope = tdual.make_rope_tables(tcfg)
    th = tdual.slow_forward(tp, tcfg, ids, trope, torch.from_numpy(prompt),
                            torch.from_numpy(positions), tkv, None, torch.from_numpy(block),
                            read_len=0)
    tl = tdual.lm_logits(tp, tcfg, th)
    tol = TOL[precision]
    assert rel(th.float(), np.asarray(jh, np.float32)) <= tol
    assert rel(tl.float(), np.asarray(jl, np.float32)) <= tol

    # the fast stack over the codebook positions from the last hidden state
    codes = np.random.default_rng(4).integers(0, tcfg.codebook_size, (2, tcfg.num_codebooks))
    jcache = jdual.new_fast_cache(jp, jcfg, 2)
    tcache = tdual.new_fast_cache(tp, tcfg, 2)
    jx, tx = jh[:, -1:], th[:, -1:]
    for pos in range(tcfg.num_codebooks):
        jlog, jcache = jdual.fast_step(jp, jcfg, jdual.make_rope_tables(jcfg), jx,
                                       jnp.int32(pos), jcache)
        tlog = tdual.fast_step(tp, tcfg, trope, tx, pos, tcache)
        assert tlog.shape == (2, 1, tcfg.codebook_size)
        assert rel(tlog.float(), np.asarray(jlog, np.float32)) <= tol, pos
        # the next position's input, the same values on both sides
        tx = tdual.qgather(tp["fast_embeddings"], torch.from_numpy(codes[:, pos]),
                           tp["norm"].dtype)[:, None]
        jx = jnp.asarray(tx.float().numpy()).astype(jp["norm"].dtype)
