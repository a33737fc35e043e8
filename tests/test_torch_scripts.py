"""The port's user scripts (``fish_tts_tpu_torch/scripts/``) on the CPU, at
tiny size: ``example_synthesis`` in each of its modes, ``encode_reference``
(a WAV in, a profile out that drives a synthesis), ``convert_checkpoint
--verify`` (passing on a clean reference directory, failing on an extra
key) and ``serve_http`` (in a subprocess through ``python -m``: a request
served from a native directory, then SIGTERM drains the stream in flight
and exits 0; ``--vocoder-device-index`` refused).

The in-process scripts share the port's ``get_instance`` singleton on one
model directory, as repeated runs of a script share a warm process.
"""

import http.client
import json
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
from test_torch_stream import one_thread  # noqa: F401 (an autouse fixture)

import fish_tts_tpu_torch
from fish_tts_tpu.testing import write_tiny_model_dir
from fish_tts_tpu_torch import VoiceProfile, testing
from fish_tts_tpu_torch.config import TINY_VOCODER_CONFIG
from fish_tts_tpu_torch.scripts import (
    convert_checkpoint,
    encode_reference,
    example_synthesis,
    serve_http,
)
from fish_tts_tpu_torch.utils.audio import to_wav_bytes

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def tiny_model_dir(tmp_path_factory):
    return write_tiny_model_dir(tmp_path_factory.mktemp("scripts") / "model")


@pytest.fixture(scope="module", autouse=True)
def _fresh_singleton():
    """The scripts go through get_instance: isolate the singleton from the
    rest of the suite, both ways."""
    fish_tts_tpu_torch.reset_instance()
    yield
    fish_tts_tpu_torch.reset_instance()


def common(model_dir) -> list[str]:
    return ["--model-dir", str(model_dir), "--device", "cpu", "--precision", "fp32"]


def is_wav(path: Path) -> bool:
    data = path.read_bytes()
    return data[:4] == b"RIFF" and len(data) > 44


@pytest.mark.parametrize("mode", ["batch", "basic", "long", "stream", "serve"])
def test_example_synthesis_modes(tiny_model_dir, tmp_path, capsys, mode):
    out = tmp_path / "o.wav"
    argv = {
        "batch": ["--batch", "first tiny text", "second one"],
        "basic": ["--text", "hello script"],
        "long": ["--long", "--max-chars", "12", "--carry-frames", "4",
                 "--text", "One two. Three four! Five six."],
        "stream": ["--stream", "--text", "hello stream"],
        "serve": ["--serve", "request one", "request two", "--slots", "2"],
    }[mode]
    assert example_synthesis.main(common(tiny_model_dir) + argv + ["-o", str(out)]) == 0
    if mode in ("batch", "serve"):
        assert all(is_wav(tmp_path / f"o-{i}.wav") for i in range(2))
    else:
        assert is_wav(out)
    if mode == "stream":
        assert "first audio after" in capsys.readouterr().out


def test_example_synthesis_mode_conflicts_error():
    """Conflicting mode flags are refused before any model loads."""
    for argv in (["--batch", "a", "--serve", "b"], ["--stream", "--batch", "a"],
                 ["--long", "--serve", "a"], ["--carry-frames", "4", "--text", "x"]):
        with pytest.raises(SystemExit) as e:
            example_synthesis.parse_args(argv)
        assert e.value.code == 2
    assert example_synthesis.parse_args([]).device == "cuda"


def test_encode_reference_profile_drives_synthesis(tiny_model_dir, tmp_path):
    """WAV in, .npy profile out, loadable and usable as a cloned voice."""
    rng = np.random.default_rng(0)
    wav = tmp_path / "ref.wav"
    wav.write_bytes(to_wav_bytes(rng.uniform(-0.3, 0.3, 4410).astype(np.float32)))
    out = tmp_path / "ref_profile.npy"
    assert encode_reference.main([str(wav), "ref", "-o", str(out), "--name", "probe"]
                                 + common(tiny_model_dir)) == 0
    profile = VoiceProfile.load(out, text="ref")
    assert profile.codes.ndim == 2 and profile.codes.shape[1] >= 1
    tts = fish_tts_tpu_torch.get_instance(model_dir=tiny_model_dir, device="cpu",
                                          precision="fp32")
    assert tts.synthesize("hi", references=[profile], max_tokens=8)[:4] == b"RIFF"
    with pytest.raises(SystemExit):
        encode_reference.main([str(wav)] + common(tiny_model_dir))  # no transcript


@pytest.fixture(scope="module")
def reference_dir(tmp_path_factory):
    """The port's tiny bundle as a reference directory (``model.pth``,
    ``codec.pth``, and ``vocoder_config.json`` for its tiny codec)."""
    return testing.write_reference_dir(tmp_path_factory.mktemp("ref") / "model",
                                       testing.make_tiny_bundle(0))


def test_convert_checkpoint_verify_passes(reference_dir, tmp_path, capsys, monkeypatch):
    """A clean directory converts, verifies and loads.  The script converts
    the codec with the default config, as the JAX script does, so the tiny
    codec's config is given to ``convert_checkpoint_dir`` here."""
    from fish_tts_tpu_torch.utils import checkpoint as ckpt

    real = ckpt.convert_checkpoint_dir
    monkeypatch.setattr(ckpt, "convert_checkpoint_dir",
                        lambda *a, **k: real(*a, vocoder_cfg=TINY_VOCODER_CONFIG, **k))
    out = tmp_path / "native"
    assert convert_checkpoint.main([str(reference_dir), str(out), "--verify"]) == 0
    text = capsys.readouterr().out
    assert "VERIFY OK" in text and "[lm]" in text and "[vocoder]" in text
    assert {"lm.safetensors", "vocoder.safetensors", "vocoder_config.json", "config.json",
            "tokenizer.tiktoken", "special_tokens.json"} <= {p.name for p in out.iterdir()}
    tts = fish_tts_tpu_torch.FishTTS(model_dir=out, device="cpu", precision="fp32",
                                     warmup=False)
    assert tts.synthesize("converted", max_tokens=6)[:4] == b"RIFF"


def test_convert_checkpoint_verify_fails_on_an_extra_key(reference_dir, tmp_path, capsys):
    """Through ``python -m``: an extra LM key is reported and the script exits
    non-zero."""
    import shutil

    import torch

    d = Path(shutil.copytree(reference_dir, tmp_path / "extra"))
    (d / "codec.pth").unlink()
    sd = torch.load(d / "model.pth", weights_only=True)
    sd["mystery_adapter.weight"] = torch.zeros(4, 4)
    torch.save(sd, d / "model.pth")
    proc = subprocess.run([sys.executable, "-m", "fish_tts_tpu_torch.scripts.convert_checkpoint",
                           str(d), str(tmp_path / "out"), "--verify"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1, proc.stderr
    assert "UNCONSUMED: mystery_adapter.weight" in proc.stdout
    assert "VERIFY FAILED" in proc.stdout


def test_serve_http_refuses_a_vocoder_device(tiny_model_dir, capsys, monkeypatch):
    """An index past the host's devices of ``--device``'s type exits 2 with
    the JAX script's message; an index in range reaches ``make_server`` as
    that device."""
    with pytest.raises(SystemExit) as e:
        serve_http.main(["--model-dir", str(tiny_model_dir), "--device", "cpu",
                         "--vocoder-device-index", "1"])
    assert e.value.code == 2
    assert ("--vocoder-device-index 1 out of range: this host has 1 device(s)"
            in capsys.readouterr().err)

    import torch

    from fish_tts_tpu_torch.serving import http as port_http

    seen = {}

    def fake_make_server(tts, **kw):
        seen.update(kw)
        raise SystemExit(0)

    monkeypatch.setattr(port_http, "make_server", fake_make_server)
    with pytest.raises(SystemExit):
        serve_http.main(["--model-dir", str(tiny_model_dir), "--device", "cpu", "--no-warmup",
                         "--vocoder-device-index", "0"])
    assert seen["vocoder_device"] == torch.device("cpu")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_http_serves_and_drains_on_sigterm(tiny_model_dir):
    port = free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "fish_tts_tpu_torch.scripts.serve_http", "--model-dir",
         str(tiny_model_dir), "--port", str(port), "--slots", "2", "--device", "cpu",
         "--no-warmup", "--precision", "fp32"],
        cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        deadline = time.time() + 180
        while True:
            try:
                c = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
                c.request("GET", "/healthz")
                if c.getresponse().status == 200:
                    c.close()
                    break
            except OSError:
                pass
            assert proc.poll() is None, "the server died while starting"
            assert time.time() < deadline, "the server did not come up"
            time.sleep(0.5)

        c = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        c.request("POST", "/synthesize", json.dumps({"text": "short", "max_new_tokens": 6}),
                  {"Content-Type": "application/json"})
        r = c.getresponse()
        assert r.status == 200 and len(r.read()) > 0
        c.close()

        # a request in flight, then SIGTERM: the stream ends and the process exits 0
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        c.request("POST", "/synthesize",
                  json.dumps({"text": "longer request", "max_new_tokens": 40}),
                  {"Content-Type": "application/json"})
        r = c.getresponse()
        assert r.status == 200 and len(r.read(2)) == 2
        proc.send_signal(signal.SIGTERM)
        assert isinstance(r.read(), bytes)
        c.close()
        assert proc.wait(timeout=120) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
