"""The port's (dp, tp) mesh against the JAX package's, on the CPU.

The JAX package runs on its eight virtual CPU devices (``tests/conftest.py``),
the port on CPU handles: torch has one CPU device, so a port mesh repeats
it, which runs the sharding and the reductions, not copies between devices.
Both take ``tests/test_parallel.py``'s tiny config (n_head 8, n_local_heads
4, so tp = 4 divides) and the same numpy weights (``from_jax_params``).

- ``make_mesh``'s shapes and errors, and ``shard_params``'s refusals, with
  the JAX package's messages;
- the head-aligned ``wqkv`` cut, int8 shards and their scales, and
  ``ShardedKV`` against the whole tensor it stands for;
- prefill logits at (dp 2, tp 4) against JAX's at (dp 2, tp 4), float32,
  within LOGIT_TOL of the largest;
- ``generate_long`` codes of the tp = 4 engines, JAX's draws replayed
  through a host noise source (a difference excused only at a knife edge of
  the port's own decision, ``testing.sample_decision_margins``);
- int8 on (dp 2, tp 4): ``generate_long``, ``set_prefix``,
  ``generate_batch`` and ``generate_batch_stream`` with per-stream
  temperatures, equal to the port's one-device plain route with the same
  seed; a ``ContinuousBatcher`` on tp = 4 serving a request's solo codes;
  no kernel on a mesh even where every gate accepts;
- ``FishTTS`` on a mesh and ``serve(vocoder_device="cpu")``.
"""

import dataclasses
import logging
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_parallel import CFG as J_CFG
from test_parallel import IDS
from test_torch_stream import generate_both, hold_codes
from test_torch_stream import one_thread  # noqa: F401 (an autouse fixture)

from fish_tts_tpu.config import EngineConfig as JEngineConfig
from fish_tts_tpu.engine.generate import GenerationEngine as JEngine
from fish_tts_tpu.models import dual_ar as jdual
from fish_tts_tpu.models.tokenizer import FishTokenizer as JTokenizer
from fish_tts_tpu.models.tokenizer import tiny_special_tokens, write_tiny_vocab
from fish_tts_tpu.parallel import mesh as jmesh
from fish_tts_tpu.parallel import sharding as jsharding
from fish_tts_tpu_torch import FishTTS, testing
from fish_tts_tpu_torch.config import DualARConfig, EngineConfig
from fish_tts_tpu_torch.engine import decode as tdecode
from fish_tts_tpu_torch.engine.generate import GenerationEngine as TEngine
from fish_tts_tpu_torch.engine.serve import ContinuousBatcher
from fish_tts_tpu_torch.models import dual_ar as tdual
from fish_tts_tpu_torch.models.dual_ar import TokenIds
from fish_tts_tpu_torch.models.tokenizer import FishTokenizer as TTokenizer
from fish_tts_tpu_torch.ops import fast_decoder, sampler_kernel, slow_stack
from fish_tts_tpu_torch.parallel import mesh as tmesh
from fish_tts_tpu_torch.parallel import sharding as tsharding
from fish_tts_tpu_torch.utils import checkpoint as tckpt
from fish_tts_tpu_torch.utils.quantize import qmm, quantize_lm_params

T_CFG = DualARConfig(**dataclasses.asdict(J_CFG))
T_IDS = TokenIds(IDS.semantic_begin, IDS.semantic_end, IDS.im_end)
CPU = torch.device("cpu")
# The logits of the (dp 2, tp 4) prefill against JAX's, relative to their
# largest: both sum the row-parallel partials in float32 in other orders.
LOGIT_TOL = 1e-5
# The engines' buckets and chunks (tests/test_parallel.py's)
ENGINE = dict(prompt_buckets=(32, 64), decode_chunk=4, first_chunk=4, kv_bucket_step=64)


@pytest.fixture(scope="module")
def eight_jax_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices (see conftest XLA_FLAGS)")
    return jax.devices()[:8]


@pytest.fixture(scope="module")
def weights():
    """(JAX f32 params, the port's copy) on the same numpy values."""
    jp = jdual.init_params(jax.random.PRNGKey(0), J_CFG, dtype=jnp.float32)
    return jp, tckpt.from_jax_params(jax.tree_util.tree_map(np.asarray, jp))


@pytest.fixture(scope="module")
def vocab():
    path = Path(tempfile.mkdtemp()) / "tokenizer.tiktoken"
    write_tiny_vocab(path)
    return path, tiny_special_tokens(num_semantic=T_CFG.codebook_size)


def cpu_mesh(tp: int, dp: int) -> tmesh.Mesh:
    return tmesh.make_mesh(tp=tp, dp=dp, devices=[CPU] * (tp * dp))


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# --- the mesh and the sharding rules ----------------------------------------------


@pytest.mark.parametrize("n,tp,dp", [(8, 4, None), (4, 2, 2), (8, 3, None), (8, 4, 3),
                                     (8, 2, 3), (8, 1, 1)])
def test_make_mesh_shapes_and_errors(eight_jax_devices, caplog, n, tp, dp):
    """The same shapes as JAX's ``make_mesh`` over as many devices, the same
    errors, and the idle-device warning."""
    try:
        want = dict(jmesh.make_mesh(tp=tp, dp=dp, devices=eight_jax_devices[:n]).shape)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            cpu_mesh_n(n, tp, dp)
        assert str(got.value) == str(e)
        return
    with caplog.at_level(logging.INFO, logger="fish_tts_tpu_torch.parallel.mesh"):
        m = cpu_mesh_n(n, tp, dp)
    assert m.shape == want and len(m.grid) == want["dp"]
    assert all(len(row) == want["tp"] for row in m.grid) and m.first == CPU
    idle = n - want["dp"] * want["tp"]
    assert any(f"{idle} left idle" in r.message for r in caplog.records) == (idle > 0)
    assert any("repeats devices" in r.message for r in caplog.records) == (
        want["dp"] * want["tp"] > 1)


def cpu_mesh_n(n: int, tp: int, dp):
    return tmesh.make_mesh(tp=tp, dp=dp, devices=[CPU] * n)


def test_make_mesh_defaults_to_the_cards():
    """``devices=None`` means every visible card: none here, which raises."""
    if torch.cuda.is_available():
        assert tmesh.single_device_mesh().first == torch.device("cuda", 0)
    else:
        with pytest.raises(ValueError, match="no CUDA device"):
            tmesh.make_mesh(tp=1)


# (config overrides, tp, int8, the axis JAX names -> the port's): the
# port's fast_output is (C, Df), JAX's (Df, C)
REFUSALS = {
    "heads": (dict(), 8, False, None),
    "intermediate": (dict(intermediate_size=192, n_head=4, n_local_heads=4), 8, False, None),
    "fast heads": (dict(fast_n_head=4, fast_n_local_heads=2), 4, False, None),
    "vocab": (dict(vocab_size=1022), 4, False, None),
    "vocab int8": (dict(vocab_size=1022), 4, True, None),
    "codebook": (dict(codebook_size=46), 4, False, ("axis 1", "axis 0")),
}


@pytest.mark.parametrize("case", REFUSALS)
def test_shard_params_refusals_match_jax(eight_jax_devices, case):
    """A tp that splits a head, the FFN's hidden dim or a sharded axis raises
    JAX's ``ValueError``, word for word but for the port's own axis order."""
    over, tp, int8, axis = REFUSALS[case]
    jcfg = dataclasses.replace(J_CFG, **over)
    tcfg = DualARConfig(**dataclasses.asdict(jcfg))
    jp = jdual.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    tp_params = tckpt.from_jax_params(jax.tree_util.tree_map(np.asarray, jp))
    if int8:
        from fish_tts_tpu.utils.quantize import quantize_lm_params as jquant
        jp, tp_params = jquant(jp), quantize_lm_params(tp_params)
    jm = jmesh.make_mesh(tp=tp, dp=1, devices=eight_jax_devices[:tp])
    with pytest.raises(ValueError) as want:
        jsharding.shard_params(jp, jcfg, jm)
    with pytest.raises(ValueError) as got:
        tsharding.shard_params(tp_params, tcfg, cpu_mesh(tp, 1))
    assert str(got.value) == (str(want.value) if axis is None
                              else str(want.value).replace(*axis))


def test_kernel_layouts_are_refused(weights):
    """Parameters carrying a ``_``-prefixed fused-kernel layout are refused,
    as JAX refuses its prepared head."""
    _, tp_params = weights
    params = dict(tp_params, _slow_head={"q": torch.zeros(8, 8, dtype=torch.int8),
                                         "s": torch.zeros(8, 1)})
    with pytest.raises(ValueError, match="_slow_head"):
        tsharding.shard_params(params, T_CFG, cpu_mesh(4, 2))


def test_wqkv_cut_is_head_aligned():
    """At tp = 2 on a config whose fused ``wqkv`` halves are not head-aligned
    (the first half is every query head), each rank's rows give its query
    heads and its KV heads of k and v, and its attention output is its
    heads' slice of the unsharded attention."""
    cfg = DualARConfig(vocab_size=64, n_layer=1, n_head=4, n_local_heads=2, dim=64, head_dim=16,
                       intermediate_size=64, max_seq_len=32, num_codebooks=2, codebook_size=8,
                       residual_codebook_size=8, n_fast_layer=1, attention_qkv_bias=True)
    params = tdual.init_params(torch.Generator().manual_seed(1), cfg, dtype=torch.float32)
    params["layers"]["wqkv_b"] = torch.randn(params["layers"]["wqkv_b"].shape,
                                             generator=torch.Generator().manual_seed(2))
    mp = tsharding.shard_params(params, cfg, cpu_mesh(2, 1))
    lp = tdual._layer(params["layers"], 0)
    h = torch.randn(2, 5, cfg.dim, generator=torch.Generator().manual_seed(3))
    q_size, kv_size = cfg.n_head * cfg.head_dim, cfg.n_local_heads * cfg.head_dim
    full = qmm(h, lp["wqkv"]) + lp["wqkv_b"]
    whole = torch.split(full, [q_size, kv_size, kv_size], dim=-1)
    halves = torch.split(full, full.shape[-1] // 2, dim=-1)
    assert torch.equal(halves[0], whole[0])  # a contiguous cut gives rank 0 no k or v
    lcfg = tsharding.local_config(cfg, 2)
    freqs = tdual.make_rope_tables(cfg)["slow"][torch.arange(5)][None].expand(2, 5, -1, -1)
    t = torch.arange(5)
    bias = torch.where(t[None, :] <= t[:, None], 0.0, tdual.NEG_INF)[None, None]
    want, _, _ = tdual._attention(lp, h, cfg, freqs, bias, None, None, None)
    for r in range(2):
        rlp = tdual._layer(mp.ranks[0][r]["layers"], 0)
        q, k, v = torch.split(qmm(h, rlp["wqkv"]) + rlp["wqkv_b"],
                              [q_size // 2, kv_size // 2, kv_size // 2], dim=-1)
        for got, full, n in ((q, whole[0], q_size // 2), (k, whole[1], kv_size // 2),
                             (v, whole[2], kv_size // 2)):
            torch.testing.assert_close(got, full[..., r * n:(r + 1) * n], rtol=1e-6, atol=1e-6)
        got, _, _ = tdual._attention(rlp, h, lcfg, freqs, bias, None, None, None)
        torch.testing.assert_close(got, want[..., r * q_size // 2:(r + 1) * q_size // 2],
                                   rtol=1e-5, atol=1e-6)


def test_int8_shards_and_scales(weights):
    """Int8 leaves on (dp 2, tp 4): a column-parallel weight's values and
    scale cut on its out axis, a row-parallel one's values on its in axis
    with the scale whole, the vocab-sharded table's rows and scales
    together; every dp row holds the same shards; the column-parallel
    products are the slices of the whole one."""
    _, tp_params = weights
    q = quantize_lm_params(tp_params)
    mp = tsharding.shard_params(q, T_CFG, cpu_mesh(4, 2))
    specs = mp.specs
    assert specs["layers"]["wqkv"] == {"q": (None, "tp", None), "s": (None, "tp", None)}
    assert specs["layers"]["wo"] == {"q": (None, None, "tp"), "s": (None, None, None)}
    assert specs["layers"]["w2"]["s"] == (None, None, None)
    assert specs["embeddings"] == {"q": ("tp", None), "s": ("tp", None)}
    L, dim, inter = T_CFG.n_layer, T_CFG.dim, T_CFG.intermediate_size
    for i in range(2):
        for r in range(4):
            p = mp.ranks[i][r]
            wo, w1, emb = p["layers"]["wo"], p["layers"]["w1"], p["embeddings"]
            assert wo["q"].shape == (L, dim, dim // 4) and torch.equal(wo["s"], q["layers"]["wo"]["s"])
            assert torch.equal(wo["q"], q["layers"]["wo"]["q"][:, :, r * dim // 4:(r + 1) * dim // 4])
            assert w1["q"].shape == (L, inter // 4, dim) and w1["s"].shape == (L, inter // 4, 1)
            rows = slice(r * T_CFG.vocab_size // 4, (r + 1) * T_CFG.vocab_size // 4)
            assert torch.equal(emb["q"], q["embeddings"]["q"][rows])
            assert torch.equal(emb["s"], q["embeddings"]["s"][rows])
    x = torch.randn(1, 4, dim, generator=torch.Generator().manual_seed(3))
    want = qmm(x, {"q": q["layers"]["w1"]["q"][0], "s": q["layers"]["w1"]["s"][0]})
    got = torch.cat([qmm(x, tdual._layer(mp.ranks[0][r]["layers"], 0)["w1"]) for r in range(4)],
                    dim=-1)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    with pytest.raises(KeyError, match="sharded"):
        mp["embeddings"]
    assert set(mp) == {"norm", "codebook_embeddings", "fast_embeddings", "fast_norm"}


@pytest.mark.parametrize("tp,dp,batch", [(2, 2, 4), (4, 2, 3), (1, 2, 2)])
def test_sharded_kv_acts_as_the_whole_tensor(tp, dp, batch):
    """``ShardedKV``'s narrow, copy_ (whole and broadcast from one row),
    zero_ and full against the same operations on a plain tensor; a batch
    that dp does not divide sits whole in dp row 0."""
    mesh = cpu_mesh(tp, dp)
    shape = (2, batch, 4, 6, 3)
    gen = torch.Generator().manual_seed(0)
    plain = torch.randn(shape, generator=gen)
    kv = tsharding.shard_kv(plain, mesh)
    assert [(i, a) for i, a, _ in kv.blocks] == [
        (i, a) for i, a, _ in tsharding.batch_rows(batch, mesh)]
    if batch % dp:
        assert len(kv.blocks) == 1
    assert torch.equal(kv.full(), plain)
    src = torch.randn((2, 1, 4, 6, 3), generator=gen)
    kv.narrow(1, 1, batch - 1).narrow(3, 0, 4).copy_(tsharding.shard_kv(src, mesh).narrow(3, 0, 4))
    plain[:, 1:, :, :4].copy_(src[:, :, :, :4])
    assert torch.equal(kv.full(), plain)
    other = torch.randn(shape, generator=gen)
    kv.narrow(3, 2, 3).copy_(tsharding.shard_kv(other, mesh).narrow(3, 1, 3))
    plain[:, :, :, 2:5].copy_(other[:, :, :, 1:4])
    assert torch.equal(kv.full(), plain)
    kv.narrow(1, 0, 1).zero_()
    plain[:, :1].zero_()
    assert torch.equal(kv.full(), plain) and kv.shape == plain.shape


def test_shard_state_and_replicate(weights):
    """``shard_state`` copies one device's decode state onto the mesh: the
    caches as ``ShardedKV``s (the batch over dp when it divides it, else
    whole in row 0), the rest on the first device; ``replicate`` gives
    every (dp row, tp rank) a copy."""
    _, tp_params = weights
    state = tdecode.init_state(tp_params, T_CFG, batch=4, max_seq_len=16)
    state["kv"]["k"].normal_(generator=torch.Generator().manual_seed(0))
    state["pos"].fill_(3)
    mesh = cpu_mesh(4, 2)
    out = tsharding.shard_state(state, mesh)
    assert [a for _, a, _ in out["kv"]["k"].blocks] == [0, 2]
    assert torch.equal(out["kv"]["k"].full(), state["kv"]["k"])
    assert out["pos"].tolist() == [3] * 4 and out["pos"] is not state["pos"]
    assert len(tsharding.shard_state(state, mesh, dp_batch=False)["kv"]["v"].blocks) == 1
    with pytest.raises(ValueError, match="divide the batch"):
        tsharding.shard_state(tdecode.init_state(tp_params, T_CFG, batch=3, max_seq_len=16),
                              mesh, dp_batch=True)
    grid = tsharding.replicate({"norm": tp_params["norm"]}, mesh)
    assert len(grid) == 2 and all(len(row) == 4 for row in grid)
    assert all(torch.equal(c["norm"], tp_params["norm"]) for row in grid for c in row)
    assert tsharding.state_specs()["kv"]["k"] == (None, "dp", "tp", None, None)
    assert tsharding.state_specs(dp_batch=False)["kv"]["v"] == (None, None, "tp", None, None)


# --- against the JAX package --------------------------------------------------------


def test_prefill_logits_match_jax_on_dp2_tp4(eight_jax_devices, weights):
    """``slow_forward`` + ``lm_logits`` over a 2-stream prompt, then the fast
    stack at every codebook position, on (dp 2, tp 4) in both packages:
    float32 logits within LOGIT_TOL of the largest, and the port's KV cache
    gathered equal to JAX's within the same."""
    jp, tp_params = weights
    jm = jmesh.make_mesh(tp=4, dp=2, devices=eight_jax_devices)
    jps = jsharding.shard_params(jp, J_CFG, jm)
    jrope = jsharding.shard_rope(jdual.make_rope_tables(J_CFG), jm)
    mp = tsharding.shard_params(tp_params, T_CFG, cpu_mesh(4, 2))
    trope = tdual.make_rope_tables(T_CFG)
    T = 16
    prompt = np.zeros((2, 1 + T_CFG.num_codebooks, T), np.int32)
    prompt[:, 0] = np.random.RandomState(0).randint(0, 1000, (2, T))
    prompt[1, 0, 4:9] = np.arange(IDS.semantic_begin, IDS.semantic_begin + 5)
    prompt[1, 1:, 4:9] = np.random.RandomState(1).randint(0, 24, (T_CFG.num_codebooks, 5))
    positions = np.tile(np.arange(T, dtype=np.int32), (2, 1))
    t_idx = np.arange(T)
    block = np.where(t_idx[None, :] <= t_idx[:, None], 0.0, np.finfo(np.float32).min)
    block = block[None, None].astype(np.float32)
    jkv = jsharding._put(jdual.init_kv_cache(J_CFG, 2, dtype=jnp.float32),
                         jsharding.state_specs()["kv"], jm)
    jh, jkv = jdual.slow_forward(jps, J_CFG, IDS, jrope, jnp.asarray(prompt),
                                 jnp.asarray(positions), jkv, None, jnp.asarray(block), read_len=0)
    jl = jdual.lm_logits(jps, J_CFG, jh)
    state = tdecode.init_state(mp, T_CFG, batch=2)
    assert isinstance(state["kv"]["k"], tsharding.ShardedKV)
    th = tdual.slow_forward(mp, T_CFG, T_IDS, trope, torch.from_numpy(prompt),
                            torch.from_numpy(positions), state["kv"], None,
                            torch.from_numpy(block), read_len=0)
    tl = tdual.lm_logits(mp, T_CFG, th)
    assert tl.shape == (2, T, T_CFG.vocab_size)
    assert rel(th, np.asarray(jh)) <= LOGIT_TOL
    assert rel(tl, np.asarray(jl)) <= LOGIT_TOL
    for k in ("k", "v"):
        assert rel(state["kv"][k].full()[:, :, :, :T], np.asarray(jkv[k])[:, :, :, :T]) <= LOGIT_TOL

    codes = np.random.default_rng(4).integers(0, T_CFG.codebook_size, (2, T_CFG.num_codebooks))
    jcache = jsharding._put(jdual.new_fast_cache(jp, J_CFG, 2), jsharding.state_specs()["kv"], jm)
    tcache = tdual.new_fast_cache(mp, T_CFG, 2)
    jx, tx = jh[:, -1:], th[:, -1:]
    for pos in range(T_CFG.num_codebooks):
        jlog, jcache = jdual.fast_step(jps, J_CFG, jrope, jx, jnp.int32(pos), jcache)
        tlog = tdual.fast_step(mp, T_CFG, trope, tx, pos, tcache)
        assert tlog.shape == (2, 1, T_CFG.codebook_size)
        assert rel(tlog, np.asarray(jlog)) <= LOGIT_TOL, pos
        tx = tdual.qgather(tp_params["fast_embeddings"], torch.from_numpy(codes[:, pos]),
                           torch.float32)[:, None]
        jx = jnp.asarray(tx.numpy())


def test_tp4_generate_long_matches_jax(eight_jax_devices, weights, vocab, monkeypatch):
    """``generate_long`` on the tp = 4 engines, the port's noise replaying the
    JAX call's draws: equal codes, or equal up to a first differing frame at
    a knife edge of the port's own decision."""
    jp, tp_params = weights
    path, specials = vocab
    jeng = JEngine(jp, J_CFG, JTokenizer(path, specials),
                   JEngineConfig(tp_size=4, dp_size=1, **ENGINE), seed=3)
    teng = TEngine(tp_params, T_CFG, TTokenizer(path, specials),
                   EngineConfig(tp_size=4, dp_size=1, **ENGINE))
    assert jeng.mesh.shape == teng.mesh.shape == {"dp": 1, "tp": 4}
    want, got, jframes, tframes, seen = generate_both(monkeypatch, (jeng, teng), "hello world",
                                                      20, streaming=False)
    assert want[0].shape == got[0].shape
    hold_codes(want, got, jframes, tframes, seen)


# --- the port's mesh engine ------------------------------------------------------


def port_engine(params, vocab, seed: int, **ecfg) -> TEngine:
    path, specials = vocab
    return TEngine(params, T_CFG, TTokenizer(path, specials),
                   EngineConfig(**(dict(sample_top_k=32, **ENGINE) | ecfg)), seed=seed)


def long_codes(engine, text: str, **kw) -> np.ndarray:
    return np.concatenate([r.codes for r in engine.generate_long(text, max_new_tokens=8, **kw)
                           if r.action == "sample"], axis=1)


def test_int8_dp2_tp4_engine_matches_one_device(weights, vocab):
    """The int8 engine on (dp 2, tp 4) gives the one-device plain route's
    codes with the same seed: ``generate_long``, ``generate_long`` through a
    ``set_prefix`` prefix, ``generate_batch`` (dp-sharded, B = 2) and
    ``generate_batch_stream`` with per-stream temperatures."""
    q = quantize_lm_params(weights[1])
    one = port_engine(q, vocab, 5, fast_kernel=False)
    mesh = port_engine(q, vocab, 5, tp_size=4, dp_size=2)
    assert mesh.mesh.shape == {"dp": 2, "tp": 4}
    ref = np.random.RandomState(0).randint(0, 24, (T_CFG.num_codebooks, 6)).astype(np.int64)

    def run(e):
        out = [long_codes(e, "hello world")]
        e.set_prefix(["ref text"], [ref])
        out.append(long_codes(e, "hello again"))
        out += e.generate_batch(["one text", "two text"], max_new_tokens=6)
        acc = [[], []]
        for chunk in e.generate_batch_stream(["one text", "two text"], max_new_tokens=6,
                                             temperature=[0.6, 1.0]):
            for b, c in enumerate(chunk):
                if c is not None:
                    acc[b].append(c)
        return out + [np.concatenate(a, axis=1) for a in acc]

    want, got = run(one), run(mesh)
    assert [c.shape for c in got] == [c.shape for c in want]
    assert all(c.shape[1] >= 1 for c in got)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    kv = mesh._prefix_state["kv"]["k"]
    assert isinstance(kv, tsharding.ShardedKV) and kv.shape[3] == T_CFG.max_seq_len


@pytest.mark.parametrize("tp,dp", [(4, 1), (2, 2)])
def test_continuous_batching_on_tp4(weights, vocab, tp, dp):
    """A ``ContinuousBatcher`` on a tp = 4 mesh (and on (dp 2, tp 2), whose
    second slot sits in dp row 1): a request served in the second slot
    equals its solo run with the same seed beside a co-tenant; the pool is
    the full context, never resized."""
    eng = port_engine(weights[1], vocab, 0, tp_size=tp, dp_size=dp)
    eng.reseed(17)
    solo = np.concatenate([r.codes for r in eng.generate_long(
        "mesh served", max_new_tokens=10, streaming=True, temperature=0.7, top_p=0.8,
        repetition_penalty=1.1) if r.action == "sample"], axis=1)
    srv = ContinuousBatcher(eng, slots=2)
    rid2 = srv.submit("co tenant", max_new_tokens=6)
    rid = srv.submit("mesh served", max_new_tokens=10, seed=17, temperature=0.7, top_p=0.8,
                     repetition_penalty=1.1)
    got, slots = {}, set()
    for ev in srv.run():
        got.setdefault(ev.request_id, []).append(ev.codes)
        slots.add((ev.request_id, ev.slot))
    assert (rid, 1) in slots  # the second slot: dp row 1 of a dp = 2 mesh
    np.testing.assert_array_equal(np.concatenate(got[rid], axis=1), solo)
    assert rid2 in got and srv.allocs == [T_CFG.max_seq_len]


def test_no_kernel_on_a_mesh(weights, vocab, monkeypatch):
    """Every kernel gate forced to accept: a one-device engine would take all
    three kernels, the mesh engine takes none, and its generation launches
    none."""
    for m in (slow_stack, sampler_kernel, fast_decoder):
        monkeypatch.setattr(m, "supports", lambda *a, **k: True)
    q = quantize_lm_params(weights[1])
    one = port_engine(q, vocab, 0)
    assert tdecode.route(T_CFG, one.params, 1, 16, **one.runner.options) == tdecode.Route(
        True, True, False, top_k=32)  # the reference's rule: top_k > 0 keeps the books plain
    eng = port_engine(q, vocab, 0, tp_size=4, dp_size=2, sample_top_k=-1)
    assert eng.runner.options["fast_kernel"] is False
    assert tdecode.route(T_CFG, eng.params, 1, 16, fast_kernel=True) == tdecode.Route(
        False, False, False)
    before = tdecode.launch_counts()
    assert long_codes(eng, "ab").shape[1] >= 1
    assert tdecode.launch_counts() == before


# --- FishTTS on a mesh and the serving codec's device -----------------------------


def test_fishtts_on_a_mesh_synthesizes_the_plain_route():
    """``FishTTS(engine_config=EngineConfig(tp_size=2, dp_size=2))`` on the
    CPU: its WAV equals the one-device plain route's, fp32."""
    def wav(**ecfg):
        tts = FishTTS(device="cpu", precision="fp32", warmup=False,
                      engine_config=EngineConfig(**ecfg), _testing_bundle=testing.make_tiny_bundle(0))
        return tts, tts.synthesize("Hello world", max_tokens=12)

    _, want = wav(fast_kernel=False)
    tts, got = wav(tp_size=2, dp_size=2)
    assert tts.engine.mesh.shape == {"dp": 2, "tp": 2} and got == want
    with pytest.raises(ValueError, match="tp_size"):
        FishTTS(device="cpu", warmup=False, devices=[CPU, CPU],
                _testing_bundle=testing.make_tiny_bundle(0))


def test_serve_on_a_vocoder_device_gives_the_same_pcm():
    """``serve(vocoder_device="cpu")``: the pool codec on its own device gives
    every request the PCM of ``vocoder_device=None``, byte for byte."""
    tts = FishTTS(device="cpu", precision="fp32", warmup=False,
                  _testing_bundle=testing.make_tiny_bundle(0))

    def pcm(vocoder_device):
        sess = tts.serve(slots=2, vocoder_device=vocoder_device, warmup=False)
        ids = [sess.submit(t, max_new_tokens=n, seed=s)
               for t, n, s in (("first voice", 14, 1), ("second", 9, 2), ("third one", 11, 3))]
        out = {i: b"" for i in ids}
        for ev in sess.run():
            out[ev.request_id] += ev.pcm
        return [out[i] for i in ids]

    want, got = pcm(None), pcm("cpu")
    assert all(len(p) > 0 for p in want) and got == want
