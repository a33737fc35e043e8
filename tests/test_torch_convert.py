"""Loading the reference's ``model.pth``/``codec.pth`` in the port, against the
JAX package, at tiny size on the CPU.

The converters (``fish_tts_tpu_torch.utils.checkpoint``) are held bit for
bit against ``fish_tts_tpu.utils.checkpoint``'s on the same state dicts,
built from seeded numpy in the reference's key layout and given once as
numpy arrays and once as ``torch.bfloat16`` tensors; their coverage reports
field by field; ``save_params`` byte for byte per key; both packages'
``convert_checkpoint_dir`` outputs read equal in both.  The reference-layout
writers of ``testing`` invert the converters.  Then the slice: a directory
holding only ``model.pth``/``codec.pth`` loads into ``FishTTS`` with the
engine parameters and codes of the native directory of the same weights,
and its codes agree with the JAX ``FishTTS`` loaded from that directory
through replayed noise, a differing code excused only at a knife edge of
the port's own decision (``test_torch_stream.hold_codes``, logits that may
each move by 1e-5 of their largest magnitude).

A torch weight-norm fold (``g * v / |v|`` in float64, rounded to f32)
gives a kernel back to within one f32 step, not bit for bit, so a codec
written with weight norm is held within that step, and bit for bit once
cast to bf16 (the precision the int8 and bf16 instances run the codec in).
"""

import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_stream import generate_both, hold_codes
from test_torch_stream import one_thread  # noqa: F401 (an autouse fixture)

from fish_tts_tpu.config import TINY_CONFIG as J_CFG
from fish_tts_tpu.config import TINY_VOCODER_CONFIG as J_VCFG
from fish_tts_tpu.models import dual_ar as jdual
from fish_tts_tpu.synthesizer import FishTTS as JFishTTS
from fish_tts_tpu.testing import make_tiny_bundle as jtiny_bundle
from fish_tts_tpu.testing import write_tiny_model_dir
from fish_tts_tpu.utils import checkpoint as jckpt
from fish_tts_tpu.utils.quantize import quantize_lm_params as jquantize
from fish_tts_tpu_torch import FishTTS, testing
from fish_tts_tpu_torch.config import TINY_CONFIG as T_CFG
from fish_tts_tpu_torch.config import TINY_VOCODER_CONFIG as T_VCFG
from fish_tts_tpu_torch.config import EngineConfig
from fish_tts_tpu_torch.models import vocoder as tvoc
from fish_tts_tpu_torch.models.tokenizer import FishTokenizer as TTokenizer
from fish_tts_tpu_torch.utils import checkpoint as tckpt

TEXT = "Load the reference checkpoint."

# (name, config overrides, state-dict options)
LM_CASES = [
    ("tiny", {}, {}),
    ("legacy_wqkv", {}, {"legacy_qkv": True}),
    ("model_prefix_wrapped", {}, {"prefix": "model.", "wrap": True}),
    ("stray_first_key", {}, {"prefix": "model.", "stray": True}),
    ("biases", {"attention_qkv_bias": True, "attention_o_bias": True,
                "fast_attention_qkv_bias": True, "fast_attention_o_bias": True}, {}),
    ("qk_norm", {"attention_qk_norm": True, "fast_attention_qk_norm": True}, {}),
    ("untied_head", {"tie_word_embeddings": False}, {}),
    ("fast_dim", {"fast_dim": 32, "fast_n_head": 2, "fast_n_local_heads": 1,
                  "fast_intermediate_size": 96}, {}),
]


def configs(overrides: dict):
    return (dataclasses.replace(J_CFG, **overrides), dataclasses.replace(T_CFG, **overrides))


def lm_state_dict(cfg, seed: int = 0, prefix: str = "", legacy_qkv: bool = False,
                  wrap: bool = False, stray: bool = False) -> dict:
    """A reference-layout ``model.pth`` state dict for ``cfg`` from seeded
    numpy, with an ``audio_*`` key the converters must drop."""
    rng = np.random.default_rng(seed)
    sd = {"epoch": np.zeros(1, np.float32)} if stray else {}

    def add(key, shape):
        sd[prefix + key] = rng.standard_normal(shape).astype(np.float32)

    add("embeddings.weight", (cfg.vocab_size, cfg.dim))
    add("codebook_embeddings.weight", (cfg.codebook_size * cfg.num_codebooks, cfg.dim))
    for stack, n, c in (("layers", cfg.n_layer, cfg), ("fast_layers", cfg.n_fast_layer,
                                                        cfg.fast_config)):
        q, kv = c.n_head * c.head_dim, c.n_local_heads * c.head_dim
        for i in range(n):
            base = f"{stack}.{i}."
            if legacy_qkv and stack == "layers":
                add(base + "attention.wq.weight", (q, c.dim))
                add(base + "attention.wk.weight", (kv, c.dim))
                add(base + "attention.wv.weight", (kv, c.dim))
            else:
                add(base + "attention.wqkv.weight", (q + 2 * kv, c.dim))
            add(base + "attention.wo.weight", (c.dim, q))
            add(base + "feed_forward.w1.weight", (c.intermediate_size, c.dim))
            add(base + "feed_forward.w3.weight", (c.intermediate_size, c.dim))
            add(base + "feed_forward.w2.weight", (c.dim, c.intermediate_size))
            add(base + "attention_norm.weight", (c.dim,))
            add(base + "ffn_norm.weight", (c.dim,))
            if c.attention_qkv_bias:
                add(base + "attention.wqkv.bias", (q + 2 * kv,))
            if c.attention_o_bias:
                add(base + "attention.wo.bias", (c.dim,))
            if c.attention_qk_norm:
                add(base + "attention.q_norm.weight", (c.head_dim,))
                add(base + "attention.k_norm.weight", (c.head_dim,))
    add("norm.weight", (cfg.dim,))
    add("fast_embeddings.weight", (cfg.codebook_size, cfg.fast_dim))
    add("fast_norm.weight", (cfg.fast_dim,))
    add("fast_output.weight", (cfg.codebook_size, cfg.fast_dim))
    if not cfg.tie_word_embeddings:
        add("output.weight", (cfg.vocab_size, cfg.dim))
    if cfg.fast_dim != cfg.dim:
        add("fast_project_in.weight", (cfg.fast_dim, cfg.dim))
        add("fast_project_in.bias", (cfg.fast_dim,))
    add("audio_projector.weight", (8, 8))
    return {"state_dict": sd} if wrap else sd


def as_bf16(sd):
    """The same state dict as torch.bfloat16 tensors (the dtype ``model.pth``
    ships in); other values as they are."""
    if isinstance(sd, dict) and "state_dict" in sd:
        return {"state_dict": as_bf16(sd["state_dict"])}
    return {k: torch.from_numpy(v).to(torch.bfloat16) if v.dtype == np.float32 else v
            for k, v in sd.items()}


def flat(tree) -> dict:
    return {k: np.asarray(v) for k, v in jckpt.flatten_params(tree).items()}


def assert_trees_equal(got, want) -> None:
    got, want = flat(got), flat(want)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def assert_reports_equal(got, want) -> None:
    assert len(got) == len(want) == 1
    assert dataclasses.asdict(got[0]) == dataclasses.asdict(want[0])
    assert got[0].summary() == want[0].summary() and got[0].ok == want[0].ok


@pytest.mark.parametrize("dtype", ["numpy", "bf16"])
@pytest.mark.parametrize("name,overrides,options", LM_CASES, ids=[c[0] for c in LM_CASES])
def test_lm_conversion_matches_jax(name, overrides, options, dtype):
    jcfg, tcfg = configs(overrides)
    sd = lm_state_dict(tcfg, **options)
    if dtype == "bf16":
        sd = as_bf16(sd)
    jrep, trep = [], []
    want = jckpt.convert_lm_state_dict(sd, jcfg, report_out=jrep)
    got = tckpt.convert_lm_state_dict(sd, tcfg, report_out=trep)
    assert_trees_equal(got, want)
    assert_reports_equal(trep, jrep)
    assert "audio_projector.weight" in trep[0].expected_dropped
    # the stray metadata entry is reported, and does not stop the prefix strip
    assert trep[0].unconsumed == (("epoch",) if name == "stray_first_key" else ())
    extra = {"fast_dim": "fast_project_in", "untied_head": "output"}.get(name)
    assert extra is None or extra in got


def test_lm_coverage_flags_extra_and_misspelled_keys():
    """An extra key is reported UNCONSUMED by both packages alike; a
    misspelled expected key raises the same KeyError naming the closest
    present keys."""
    sd = lm_state_dict(T_CFG)
    sd["mystery_adapter.weight"] = np.zeros((4, 4), np.float32)
    jrep, trep = [], []
    jckpt.convert_lm_state_dict(sd, J_CFG, report_out=jrep)
    tckpt.convert_lm_state_dict(sd, T_CFG, report_out=trep)
    assert_reports_equal(trep, jrep)
    assert trep[0].unconsumed == ("mystery_adapter.weight",) and not trep[0].ok

    sd = lm_state_dict(T_CFG)
    sd["nrom.weight"] = sd.pop("norm.weight")
    with pytest.raises(KeyError) as jerr:
        jckpt.convert_lm_state_dict(sd, J_CFG)
    with pytest.raises(KeyError) as terr:
        tckpt.convert_lm_state_dict(sd, T_CFG)
    assert str(terr.value) == str(jerr.value)
    assert "closest present keys" in str(terr.value) and "nrom.weight" in str(terr.value)


def loud_codec(seed: int = 1):
    """The tiny codec in the port's layout, every leaf jittered by seeded
    numpy (the initializer's zeros and ones would hide a swapped leaf)."""
    rng = np.random.default_rng(seed)
    tree = tvoc.init_vocoder_params(torch.Generator().manual_seed(seed), T_VCFG)
    return jax.tree_util.tree_map(
        lambda t: t + 0.05 * torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)),
        tree)


DECODER_TRANSFORMER_KEY = "decoder.model.1.block.5.attention.wqkv.weight"


@pytest.mark.parametrize("dtype", ["numpy", "bf16"])
@pytest.mark.parametrize("prefix", ["generator.", ""])
@pytest.mark.parametrize("naming", ["parametrizations", "legacy"])
def test_vocoder_conversion_matches_jax(naming, prefix, dtype):
    """Both weight-norm namings, with and without ``generator.``; a decoder
    transformer key lands in ``expected_dropped`` in both packages."""
    sd = testing.to_reference_codec_state_dict(loud_codec(), T_VCFG, naming=naming,
                                               prefix=prefix)
    sd[prefix + DECODER_TRANSFORMER_KEY] = torch.zeros((4, 4))
    sd = ({k: v.to(torch.bfloat16) for k, v in sd.items()} if dtype == "bf16"
          else {k: v.numpy() for k, v in sd.items()})
    jrep, trep = [], []
    want = jckpt.convert_vocoder_state_dict(sd, J_VCFG, report_out=jrep)
    got = tckpt.convert_vocoder_state_dict(sd, T_VCFG, report_out=trep)
    assert_trees_equal(got, want)
    assert_reports_equal(trep, jrep)
    assert trep[0].ok and trep[0].expected_dropped == (DECODER_TRANSFORMER_KEY,)


def mixed_tree() -> dict:
    rng = np.random.default_rng(4)
    return {"w": rng.standard_normal((16, 8)).astype(np.float32),
            "norm": rng.standard_normal(8).astype(np.float32),
            "codes": np.arange(6, dtype=np.int32),
            "f64": rng.standard_normal((2, 2)),
            "list": [{"w": rng.standard_normal((3, 2, 5)).astype(np.float32)}],
            "lm": jckpt.convert_lm_state_dict(lm_state_dict(T_CFG), J_CFG)}


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_save_params_matches_jax(tmp_path, dtype):
    """Per key the same dtype, shape and bytes as the JAX ``save_params``
    writes, read back through the JAX ``load_params``."""
    tree = mixed_tree()
    tckpt.save_params(tmp_path / "port.safetensors", tree, dtype=dtype)
    jckpt.save_params(tmp_path / "jax.safetensors", tree, dtype=dtype)
    got = flat(jckpt.load_params(tmp_path / "port.safetensors"))
    want = flat(jckpt.load_params(tmp_path / "jax.safetensors"))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert (got[k].dtype, got[k].shape) == (w.dtype, w.shape), k
        assert got[k].tobytes() == w.tobytes(), k
    kinds = {k: v.dtype.name for k, v in got.items()}
    assert kinds["norm"] == "float32" and kinds["codes"] == "int32"
    assert kinds["w"] == ("bfloat16" if dtype == "bf16" else "float32")


def test_save_params_rejects_another_dtype(tmp_path):
    with pytest.raises(ValueError, match="dtype"):
        tckpt.save_params(tmp_path / "x.safetensors", {"w": np.zeros((2, 2), np.float32)},
                          dtype="fp16")


def tiny_reference_dir(root, naming="parametrizations", lm_dtype=torch.float32):
    """The JAX tiny bundle (seed 0, the weights of ``write_tiny_model_dir``)
    written as a reference checkpoint directory by the port's writers."""
    _, jp, _, _, jvp = jtiny_bundle(0)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    tok = testing._byte_tokenizer(testing.tiny_special_tokens(T_CFG.codebook_size))
    bundle = (T_CFG, tckpt.from_jax_params(to_np(jp)), tok, T_VCFG,
              tckpt.from_jax_params(to_np(jvp)))
    return testing.write_reference_dir(root, bundle, naming=naming, lm_dtype=lm_dtype)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("convert")
    return {"reference": tiny_reference_dir(root / "reference"),
            "plain": tiny_reference_dir(root / "plain", naming=None),
            "native": write_tiny_model_dir(root / "native", seed=0)}


def test_reference_dir_holds_only_the_reference_files(dirs):
    assert sorted(p.name for p in dirs["reference"].iterdir()) == [
        "codec.pth", "config.json", "model.pth", "special_tokens.json", "tokenizer.tiktoken",
        "vocoder_config.json"]


def test_converted_dirs_load_equal_in_both_packages(dirs, tmp_path):
    """Each package's ``convert_checkpoint_dir`` of one reference directory:
    the same files, read equal by both packages' loaders, with equal
    coverage reports."""
    jout, tout = tmp_path / "jax", tmp_path / "port"
    jreps = jckpt.convert_checkpoint_dir(dirs["reference"], jout, vocoder_cfg=J_VCFG)
    treps = tckpt.convert_checkpoint_dir(dirs["reference"], tout, vocoder_cfg=T_VCFG)
    assert {k: dataclasses.asdict(v) for k, v in treps.items()} == {
        k: dataclasses.asdict(v) for k, v in jreps.items()}
    assert all(r.ok for r in treps.values())
    assert sorted(p.name for p in tout.iterdir()) == sorted(p.name for p in jout.iterdir())
    assert (json.loads((tout / "vocoder_config.json").read_text())
            == json.loads((jout / "vocoder_config.json").read_text()))
    for name in ("lm.safetensors", "vocoder.safetensors"):
        want = flat(jckpt.load_params(jout / name))
        assert_trees_equal(jckpt.load_params(tout / name), want)
        for d in (jout, tout):
            got = tckpt.load_safetensors(d / name)
            for k, w in want.items():
                g = got[k]
                g = g.view(torch.int16).numpy() if g.dtype == torch.bfloat16 else g.numpy()
                w = w.view(np.int16) if w.dtype.name == "bfloat16" else w
                np.testing.assert_array_equal(g, w, err_msg=f"{d.name}/{name}/{k}")


def test_lm_round_trip_is_exact():
    _, params, *_ = testing.make_tiny_bundle(0)
    sd = testing.to_reference_lm_state_dict(params, T_CFG, dtype=torch.float32)
    back = tckpt.from_jax_params(tckpt.convert_lm_state_dict(sd, T_CFG))
    assert_trees_equal(jax.tree_util.tree_map(lambda t: t.numpy(), back),
                       jax.tree_util.tree_map(lambda t: t.numpy(), params))


F32_STEP = 2.0 ** -23  # one f32 step relative to the magnitude


def bf16_valued(tree):
    """A float32 tree whose values are bf16 numbers (as a bf16 checkpoint's)."""
    return jax.tree_util.tree_map(lambda t: t.to(torch.bfloat16).float(), tree)


@pytest.mark.parametrize("naming", testing.WEIGHT_NORM_NAMINGS)
def test_codec_round_trip(naming):
    """Without weight norm the codec comes back bit for bit; with it each
    folded kernel within one f32 step, and bit for bit when its values are
    bf16 numbers and it is cast back to bf16."""
    *_, vparams = testing.make_tiny_bundle(0)
    for tree in (vparams, bf16_valued(vparams)):
        sd = testing.to_reference_codec_state_dict(tree, T_VCFG, naming=naming)
        back = tckpt.from_jax_params(tckpt.convert_vocoder_state_dict(sd, T_VCFG))
        got = flat(jax.tree_util.tree_map(lambda t: t.numpy(), back))
        want = flat(jax.tree_util.tree_map(lambda t: t.numpy(), tree))
        if naming is None:
            assert_trees_equal(got, want)
            continue
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            assert (np.abs(got[k] - want[k]) <= F32_STEP * np.abs(want[k])).all(), k
    bits = lambda tree: jax.tree_util.tree_map(  # noqa: E731
        lambda t: t.to(torch.bfloat16).view(torch.int16).numpy(), tree)
    assert_trees_equal(bits(back), bits(tree))


# --- the slice: a reference directory through FishTTS ----------------------------


def test_fishtts_loads_the_reference_dir_like_the_native_one(dirs):
    """``FishTTS(model_dir=<model.pth, codec.pth>)`` (plain codec kernels,
    so that the f32 weights are the native directory's to the bit): the int8
    engine parameters that ``test_torch_api`` holds for the native directory
    (the JAX package's bf16 cast, quantized, transposed), the same codec in
    bf16 and, with the same seed, the same codes and WAV as the native
    directory gives."""
    kw = dict(device="cpu", precision="int8", warmup=False, seed=5)
    ref = FishTTS(model_dir=dirs["plain"], **kw)
    native = FishTTS(model_dir=dirs["native"], **kw)
    _, jp, *_ = jtiny_bundle(0)
    jq = jquantize(jdual.cast_params(jp, jnp.bfloat16))
    tp = ref.engine.params
    for stack in ("layers", "fast_layers"):
        for k in ("wqkv", "wo", "w1", "w3", "w2"):
            for part in ("q", "s"):
                np.testing.assert_array_equal(
                    tp[stack][k][part].numpy(), np.swapaxes(np.asarray(jq[stack][k][part]), 1, 2))
    assert_trees_equal(jax.tree_util.tree_map(lambda t: t.float().numpy(), tp),
                       jax.tree_util.tree_map(lambda t: t.float().numpy(), native.engine.params))
    assert_trees_equal(
        jax.tree_util.tree_map(lambda t: t.view(torch.int16).numpy(), ref._vocoder_params),
        jax.tree_util.tree_map(lambda t: t.view(torch.int16).numpy(), native._vocoder_params))
    assert ref._vocoder_cfg == native._vocoder_cfg == T_VCFG
    codes = []
    for tts in (ref, native):
        out = list(tts.engine.generate_long(TEXT, max_new_tokens=24, temperature=0.7,
                                            top_p=0.8, repetition_penalty=1.1))
        codes.append(out[0].codes)
    np.testing.assert_array_equal(codes[0], codes[1])
    assert codes[0].shape[1] > 3
    ref.engine.reseed(9)
    native.engine.reseed(9)
    assert ref.synthesize(TEXT, max_tokens=12) == native.synthesize(TEXT, max_tokens=12)


def test_lm_weights_missing_raises(tmp_path, dirs):
    d = shutil.copytree(dirs["reference"], tmp_path / "m")
    (d / "model.pth").unlink()
    with pytest.raises(FileNotFoundError, match="No LM weights"):
        FishTTS(model_dir=d, device="cpu", warmup=False)


def test_codes_match_the_jax_fishtts_on_the_reference_dir(dirs, monkeypatch):
    """The JAX ``FishTTS`` and the port's on the same ``.pth`` directory
    (fp32, the plain route the JAX package takes on the CPU), with noise
    replaying the JAX call's draws: the same codes, but at a knife edge."""
    jtts = JFishTTS(model_dir=dirs["reference"], device="cpu", precision="fp32", warmup=False)
    ttts = FishTTS(model_dir=dirs["reference"], device="cpu", precision="fp32", warmup=False,
                   engine_config=EngineConfig(fast_kernel=False))
    assert isinstance(ttts._tokenizer, TTokenizer)
    want, got, jframes, tframes, seen = generate_both(monkeypatch, (jtts._engine, ttts.engine),
                                                      TEXT, 30, streaming=False)
    assert sum(c.shape[1] for c in want) > 3
    hold_codes(want, got, jframes, tframes, seen)


def test_weight_norm_dir_synthesizes_like_the_bundle(tmp_path):
    """The chip smoke's ``convert`` phase at tiny size: a bundle of bf16
    values written as ``model.pth`` (bf16) and ``codec.pth`` (f32, weight
    norm in ``parametrizations``), loaded by ``FishTTS`` and after
    ``convert_checkpoint_dir``, gives the in-memory bundle's WAV bit for bit
    with the same seed (int8: the codec runs in bf16)."""
    cfg, params, tok, vcfg, vparams = testing.make_tiny_bundle(0)
    bundle = (cfg, bf16_valued(params), tok, vcfg, bf16_valued(vparams))
    ref = testing.write_reference_dir(tmp_path / "ref", bundle, naming="parametrizations",
                                      lm_dtype=torch.bfloat16)
    reports = tckpt.convert_checkpoint_dir(ref, tmp_path / "native", vocoder_cfg=vcfg)
    assert all(r.ok for r in reports.values())
    kw = dict(device="cpu", precision="int8", warmup=True, seed=3)
    wavs = [FishTTS(_testing_bundle=bundle, **kw).synthesize(TEXT, max_tokens=10)]
    for d in (ref, tmp_path / "native"):
        wavs.append(FishTTS(model_dir=d, **kw).synthesize(TEXT, max_tokens=10))
    assert len(wavs[0]) > 44 and wavs[1] == wavs[0] and wavs[2] == wavs[0]
