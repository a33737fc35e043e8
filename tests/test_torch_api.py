"""The port's public surface on the CPU, against the JAX package where the two
can be compared: loading a native model directory, ``references=`` through
``build_prompt``, ``VoiceProfile``, the singleton, the package's imports,
``chip_smoke.py``'s refusal to run without a GPU, configs with attention
biases and qk-norm (their flags and their weights, against JAX) and every
precision, with ``bf16`` the default."""

import dataclasses
import io
import json
import shutil
import subprocess
import sys
import wave
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_tts_tpu.models import dual_ar as jdual
from fish_tts_tpu.models.prompt import build_prompt as jbuild_prompt
from fish_tts_tpu.models.tokenizer import FishTokenizer as JTokenizer
from fish_tts_tpu.testing import make_tiny_bundle as jtiny_bundle
from fish_tts_tpu.testing import write_tiny_model_dir
from fish_tts_tpu.utils.quantize import quantize_lm_params as jquantize
from fish_tts_tpu_torch import FishTTS, VoiceProfile, get_instance, reset_instance
from fish_tts_tpu_torch.config import DualARConfig
from fish_tts_tpu_torch.engine import generate as tgenerate
from fish_tts_tpu_torch.models import dual_ar as tdual
from fish_tts_tpu_torch.testing import make_tiny_bundle as ttiny_bundle
from fish_tts_tpu_torch.utils import checkpoint as tckpt
from test_torch_stream import one_thread  # noqa: F401 (an autouse fixture)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return write_tiny_model_dir(tmp_path_factory.mktemp("tiny_model"), seed=0)


@pytest.fixture(scope="module")
def tts(model_dir):
    return FishTTS(model_dir=model_dir, device="cpu", precision="int8", warmup=False)


def _wav_frames(wav: bytes) -> int:
    with wave.open(io.BytesIO(wav)) as w:
        assert (w.getnchannels(), w.getsampwidth(), w.getframerate()) == (1, 2, 44100)
        return w.getnframes()


def test_model_dir_int8_weights_match_jax(tts):
    """A native directory loads into the JAX package's int8 weights (bf16
    cast, then quantized), transposed to (out, in): bit-equal."""
    _, jp, *_ = jtiny_bundle(0)
    jq = jquantize(jdual.cast_params(jp, jnp.bfloat16))
    tp = tts.engine.params
    for stack in ("layers", "fast_layers"):
        for k in ("wqkv", "wo", "w1", "w3", "w2"):
            np.testing.assert_array_equal(
                tp[stack][k]["q"].numpy(), np.swapaxes(np.asarray(jq[stack][k]["q"]), 1, 2))
            np.testing.assert_array_equal(
                tp[stack][k]["s"].numpy(), np.swapaxes(np.asarray(jq[stack][k]["s"]), 1, 2))
    np.testing.assert_array_equal(tp["embeddings"]["q"].numpy(),
                                  np.asarray(jq["embeddings"]["q"]))
    n = _wav_frames(tts.synthesize("Hi.", max_tokens=6))
    assert 0 < n <= 5 * tts._vocoder_cfg.frame_length


def test_references_reach_the_prompt(tts, model_dir, monkeypatch):
    """``synthesize(references=...)`` builds the JAX package's prompt."""
    K = tts._cfg.num_codebooks
    rng = np.random.default_rng(1)
    profile = VoiceProfile(codes=rng.integers(0, 24, (K, 7)), text="Ref words.")
    seen = []
    real = tgenerate.build_prompt

    def spy(*a, **k):
        enc = real(*a, **k)
        seen.append(enc.values)
        return enc

    monkeypatch.setattr(tgenerate, "build_prompt", spy)
    n = _wav_frames(tts.synthesize("Target.", references=[profile], max_tokens=4))
    assert n > 0
    jtok = JTokenizer.from_pretrained(model_dir)
    want = jbuild_prompt(jtok, "Target.", K, prompt_texts=["Ref words."],
                         prompt_codes=[profile.codes]).values
    np.testing.assert_array_equal(seen[-1], want)


def test_voice_profile_npy_roundtrip(tmp_path):
    codes = np.arange(20, dtype=np.int64).reshape(4, 5)
    VoiceProfile(codes=codes, text="t").save(tmp_path / "voice.npy")
    loaded = VoiceProfile.load(tmp_path / "voice.npy", text="t")
    np.testing.assert_array_equal(loaded.codes, codes)
    assert (loaded.text, loaded.name) == ("t", "voice")


def test_singleton(model_dir):
    reset_instance()
    try:
        a = get_instance(model_dir=model_dir, device="cpu", warmup=False)
        assert get_instance() is a
        reset_instance()
        assert get_instance(model_dir=model_dir, device="cpu", warmup=False) is not a
    finally:
        reset_instance()


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import fish_tts_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "wanted = {'engine.serve', 'serving.http', 'utils.text', 'synthesizer', 'models.api',\n"
        "          'scripts.convert_checkpoint', 'scripts.encode_reference',\n"
        "          'scripts.example_synthesis', 'scripts.serve_http', 'scripts._timing',\n"
        "          'scripts.benchmark', 'scripts.verify_sampler', 'scripts.ab_kernel_gates',\n"
        "          'scripts.ab_kvbucket', 'scripts.profile_decode', 'scripts.profile_batch',\n"
        "          'scripts.profile_slow_parts', 'scripts.profile_vocoder',\n"
        "          'scripts.profile_serving'}\n"
        "assert {p.__name__ + '.' + m for m in wanted} <= set(names), names\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'fish_tts_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_refuses_without_a_gpu(tmp_path, where):
    """Without a CUDA device, or away from the package, the smoke script
    exits non-zero and prints no result."""
    script = ROOT / "chip_smoke.py"
    if where == "alone":
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    proc = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


FLAGS = ["attention_qkv_bias", "attention_o_bias", "attention_qk_norm",
         "fast_attention_qkv_bias", "fast_attention_o_bias", "fast_attention_qk_norm"]
FP32_TOL = 1e-5  # relative to the largest magnitude: f32 sums in another order


def _randomize(tree: dict, seed: int) -> dict:
    """Biases and qk-norm gains from numpy, not ``init_params``' zeros and ones."""
    rng = np.random.default_rng(seed)
    out = dict(tree)
    for stack in ("layers", "fast_layers"):
        st = dict(out[stack])
        for k in ("wqkv_b", "wo_b", "q_norm", "k_norm"):
            if k in st:
                base = 1.0 if k.endswith("norm") else 0.0
                st[k] = (base + 0.2 * rng.standard_normal(st[k].shape)).astype(np.float32)
        out[stack] = st
    return out


def _forward_logits(dual, cfg, params, ids, prompt, to):
    """Prompt logits of the slow stack and position-1 logits of the fast
    stack, in either package (``to`` makes its arrays)."""
    T = prompt.shape[-1]
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), prompt.shape[:1] + (T,))
    t_idx = np.arange(T)
    block = np.where(t_idx[None, :] <= t_idx[:, None], 0.0,
                     np.finfo(np.float32).min)[None, None].astype(np.float32)
    rope = dual.make_rope_tables(cfg)
    kv = dual.init_kv_cache(cfg, prompt.shape[0], dtype=params["norm"].dtype)
    out = dual.slow_forward(params, cfg, ids, rope, to(prompt), to(np.ascontiguousarray(pos)), kv,
                            None, to(block), read_len=0)
    hidden = out[0] if isinstance(out, tuple) else out
    cache = dual.new_fast_cache(params, cfg, prompt.shape[0])
    step = dual.fast_step(params, cfg, rope, hidden[:, -1:], 0 if to is torch.from_numpy
                          else jnp.int32(0), cache)
    fast = step[0] if isinstance(step, tuple) else step
    return (np.asarray(dual.lm_logits(params, cfg, hidden), np.float32),
            np.asarray(fast, np.float32))


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("flag", FLAGS)
def test_attention_flag_configs_load_and_match_jax(model_dir, tmp_path, flag):
    """A model directory whose config sets an attention bias or qk-norm (and
    whose checkpoint holds the weights, randomized) loads into the JAX
    package's config and weights, gives JAX's slow and fast logits, and
    synthesizes a WAV."""
    from fish_tts_tpu.config import DualARConfig as JConfig
    from fish_tts_tpu.utils import checkpoint as jckpt

    d = Path(shutil.copytree(model_dir, tmp_path / "model"))
    cfg_json = json.loads((d / "config.json").read_text())
    cfg_json[flag] = True
    (d / "config.json").write_text(json.dumps(cfg_json))
    jcfg = JConfig.from_json(d)
    jp = _randomize(jax.tree_util.tree_map(
        np.asarray, jdual.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)), 1)
    jckpt.save_params(d / "lm.safetensors", jp, dtype="fp32")

    tcfg = DualARConfig.from_json(d)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg) and getattr(tcfg, flag)
    tts = FishTTS(model_dir=d, device="cpu", precision="fp32", warmup=False)
    jtok = JTokenizer.from_pretrained(d)
    ids = jdual.TokenIds(jtok.semantic_begin_id, jtok.semantic_end_id, jtok.im_end_id)
    prompt = jbuild_prompt(jtok, "Hello there.", jcfg.num_codebooks).values[None]
    want = _forward_logits(jdual, jcfg, jax.tree_util.tree_map(jnp.asarray, jp), ids, prompt,
                           jnp.asarray)
    got = _forward_logits(tdual, tcfg, tts.engine.params, ids, prompt, torch.from_numpy)
    for g, w in zip(got, want):
        assert _rel(g, w) <= FP32_TOL
    assert _wav_frames(tts.synthesize("Hi.", max_tokens=4)) > 0


@pytest.mark.parametrize("weight", ["wqkv_b", "wo_b", "q_norm", "k_norm"])
def test_attention_weights_carry_through_and_change_the_output(weight):
    """A bias or qk-norm weight of either stack comes through
    ``from_jax_params`` in its own layout, equal to JAX's, and changes the
    logits: dropping it would show."""
    flag = {"wqkv_b": "qkv_bias", "wo_b": "o_bias"}.get(weight, "qk_norm")
    # both stacks: a replaced config keeps the fast flags its source resolved
    flags = {f"attention_{flag}": True, f"fast_attention_{flag}": True}
    jcfg = dataclasses.replace(jtiny_bundle(0)[0], **flags)
    tcfg = dataclasses.replace(ttiny_bundle(0)[0], **flags)
    tree = _randomize(jax.tree_util.tree_map(
        np.asarray, jdual.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)), 2)
    tp = tckpt.from_jax_params(tree)
    for stack in ("layers", "fast_layers"):
        np.testing.assert_array_equal(tp[stack][weight].numpy(), tree[stack][weight])
    ids = jdual.TokenIds(tcfg.vocab_size - tcfg.codebook_size, tcfg.vocab_size - 1, 4)
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, tcfg.codebook_size, (1, 1 + tcfg.num_codebooks, 9)).astype(np.int32)
    prompt[0, 0] = rng.integers(0, tcfg.vocab_size, 9)
    got = _forward_logits(tdual, tcfg, tp, ids, prompt, torch.from_numpy)
    want = _forward_logits(jdual, jcfg, jax.tree_util.tree_map(jnp.asarray, tree), ids, prompt,
                           jnp.asarray)
    for g, w in zip(got, want):
        assert _rel(g, w) <= FP32_TOL
    plain = {k: (dict(v) if k in ("layers", "fast_layers") else v) for k, v in tp.items()}
    for stack in ("layers", "fast_layers"):
        neutral = 1.0 if weight.endswith("norm") else 0.0
        plain[stack][weight] = torch.full_like(tp[stack][weight], neutral)
    without = _forward_logits(tdual, tcfg, plain, ids, prompt, torch.from_numpy)
    for g, w in zip(got, without):
        assert _rel(g, w) > 1e-3


@pytest.mark.parametrize("precision", ["bf16", "fp16", "fp32", "int8"])
def test_every_precision_synthesizes_a_wav(precision):
    """Each precision synthesizes a valid WAV; its LM, cache and codec take
    the precision's dtype (int8: int8 matmul weights over bf16), and bf16 is
    the default, as in the JAX package."""
    dtype = {"bf16": torch.bfloat16, "fp16": torch.float16, "fp32": torch.float32,
             "int8": torch.bfloat16}[precision]
    tts = FishTTS(device="cpu", precision=precision, _testing_bundle=ttiny_bundle(0))
    assert tts.precision == precision
    p = tts.engine.params
    assert p["norm"].dtype == dtype
    assert (p["layers"]["wqkv"]["q"].dtype == torch.int8) if precision == "int8" else (
        p["layers"]["wqkv"].dtype == dtype)
    n = _wav_frames(tts.synthesize("Hello world", max_tokens=8))
    assert 0 < n <= 7 * tts._vocoder_cfg.frame_length
    assert next(iter(tts.engine._states.values()))["kv"]["k"].dtype == dtype
    if precision == "bf16":
        assert FishTTS(device="cpu", warmup=False,
                       _testing_bundle=ttiny_bundle(0)).precision == "bf16"
        with pytest.raises(ValueError):
            FishTTS(device="cpu", precision="int4", _testing_bundle=ttiny_bundle(0))
