"""The port's public surface on the CPU, against the JAX package where the two
can be compared: loading a native model directory, ``references=`` through
``build_prompt``, ``VoiceProfile``, the singleton, the package's imports,
``chip_smoke.py``'s refusal to run without a GPU, and the refusal of what
the port does not run yet (attention biases and qk-norm, ``fp16``)."""

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

from fish_tts_tpu.models import dual_ar as jdual
from fish_tts_tpu.models.prompt import build_prompt as jbuild_prompt
from fish_tts_tpu.models.tokenizer import FishTokenizer as JTokenizer
from fish_tts_tpu.testing import make_tiny_bundle as jtiny_bundle
from fish_tts_tpu.testing import write_tiny_model_dir
from fish_tts_tpu.utils.quantize import quantize_lm_params as jquantize
from fish_tts_tpu_torch import FishTTS, VoiceProfile, get_instance, reset_instance
from fish_tts_tpu_torch.config import DualARConfig
from fish_tts_tpu_torch.engine import generate as tgenerate
from fish_tts_tpu_torch.testing import make_tiny_bundle as ttiny_bundle
from fish_tts_tpu_torch.utils import checkpoint as tckpt

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
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
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


@pytest.mark.parametrize("flag", ["attention_qkv_bias", "attention_o_bias",
                                  "attention_qk_norm", "fast_attention_qkv_bias",
                                  "fast_attention_o_bias", "fast_attention_qk_norm"])
def test_unported_attention_flags_raise(model_dir, tmp_path, flag):
    """A config that sets an attention bias or qk-norm is refused at load:
    the port's stack and kernels would drop it without an error."""
    d = Path(shutil.copytree(model_dir, tmp_path / "model"))
    cfg = json.loads((d / "config.json").read_text())
    cfg[flag] = True
    (d / "config.json").write_text(json.dumps(cfg))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DualARConfig.from_json(d)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        FishTTS(model_dir=d, device="cpu", warmup=False)


@pytest.mark.parametrize("weight", ["wqkv_b", "wo_b", "q_norm", "k_norm"])
def test_unported_attention_weights_raise(weight):
    """An LM tree holding a bias or qk-norm weight is refused, in either
    stack."""
    _, jp, *_ = jtiny_bundle(0)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tckpt.from_jax_params(tree)  # the plain tree loads
    for stack in ("layers", "fast_layers"):
        bad = dict(tree, **{stack: dict(tree[stack], **{weight: np.zeros((2, 4), np.float32)})})
        with pytest.raises(NotImplementedError, match=weight):
            tckpt.from_jax_params(bad)


def test_fp16_precision_raises_like_the_other_unported_ones():
    with pytest.raises(NotImplementedError):
        FishTTS(device="cpu", precision="fp16", _testing_bundle=ttiny_bundle(0))
    with pytest.raises(ValueError):
        FishTTS(device="cpu", precision="int4", _testing_bundle=ttiny_bundle(0))
