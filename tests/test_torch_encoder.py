"""The codec encoder in the port against the JAX package, at tiny size on the
CPU: ``encoder_forward``, ``quantizer_encode`` and ``dac_encode`` on seeded
audio (B = 2, lengths not a frame multiple), the encode's shape contract and
an encode of a decode, ``FishTTS.encode_reference`` against the JAX
instance's, and ``PUT /voices`` on the port's HTTP server.

Tolerances: latents within ``LATENT_TOL`` of their largest magnitude (f32
convolutions and products summed in another order); codes equal, a
differing one excused only where the port's own float64 similarities of the
two codebook entries are within ``TIE_MARGIN``
(``testing.vq_decision_margins``): the argmax runs over normalized
8-dimensional vectors, and once a code differs the residual of every later
book of that frame does too.
"""

import base64
import http.client
import json
import threading
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_stream import loud_vocoder
from test_torch_stream import one_thread  # noqa: F401 (an autouse fixture)

from fish_tts_tpu.config import TINY_VOCODER_CONFIG as J_VCFG
from fish_tts_tpu.models import vocoder as jvoc
from fish_tts_tpu.synthesizer import FishTTS as JFishTTS
from fish_tts_tpu.testing import make_tiny_bundle as jax_bundle
from fish_tts_tpu_torch import FishTTS, testing
from fish_tts_tpu_torch.config import TINY_VOCODER_CONFIG as T_VCFG
from fish_tts_tpu_torch.models import vocoder as tvoc
from fish_tts_tpu_torch.serving.http import _make_handler, make_server
from fish_tts_tpu_torch.utils.audio import to_wav_bytes

LATENT_TOL = 1e-4
TIE_MARGIN = 1e-4
FL = T_VCFG.frame_length


@pytest.fixture(scope="module")
def vparams():
    return loud_vocoder()


def audio(seed: int, T: int, B: int = 2) -> np.ndarray:
    """Seeded noise under a slow envelope, (B, 1, T) float32."""
    rng = np.random.default_rng(seed)
    env = np.sin(np.linspace(0, 7, T))[None, None] * 0.5
    return (rng.standard_normal((B, 1, T)) * 0.3 * env).astype(np.float32)


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def hold_codes(codes, want, tp, latent) -> dict:
    """Codes against JAX's: equal, or differing first at a near tie of the
    port's own similarities on the codebooks' input of ``latent``."""
    codes, want = torch.as_tensor(np.asarray(codes)), torch.as_tensor(np.asarray(want))
    assert codes.shape == want.shape
    z = tvoc.quantizer_latent(tp["quantizer"], T_VCFG, torch.from_numpy(np.asarray(latent)))
    m = testing.vq_decision_margins(codes, want, tp["quantizer"], z, TIE_MARGIN)
    assert not m["failures"], m["failures"]
    return m


@pytest.mark.parametrize("T", [3 * FL + 37, 2 * FL - 1, 5 * FL + FL // 2])
def test_encoder_forward_matches_jax(vparams, T):
    tp, jp = vparams
    x = audio(T, T)
    got = tvoc.encoder_forward(tp["encoder"], T_VCFG, torch.from_numpy(x)).numpy()
    want = np.asarray(jvoc.encoder_forward(jp["encoder"], J_VCFG, jnp.asarray(x)))
    assert got.shape == want.shape
    assert rel(got, want) <= LATENT_TOL


def test_quantizer_encode_matches_jax(vparams):
    """On the JAX encoder's latent: the codebooks' input within LATENT_TOL of
    the JAX quantizer's, the codes equal but at near ties."""
    tp, jp = vparams
    x = audio(1, 4 * FL + 5)
    latent = np.array(jvoc.encoder_forward(jp["encoder"], J_VCFG, jnp.asarray(x)))
    want = np.asarray(jvoc.quantizer_encode(jp["quantizer"], J_VCFG, jnp.asarray(latent)))
    got = tvoc.quantizer_encode(tp["quantizer"], T_VCFG, torch.from_numpy(latent))
    assert got.dtype == torch.int64
    hold_codes(got, want, tp, latent)
    qp = jp["quantizer"]
    z = jnp.asarray(latent)
    for stage, f in zip(qp["downsample"], J_VCFG.downsample_factor):
        z = jvoc._convnext(stage["convnext"], jvoc.causal_conv1d(
            z, stage["conv"]["w"], stage["conv"]["b"], stride=f))
    z = jvoc._wlt_forward(qp["pre"], J_VCFG.quantizer_transformer, J_VCFG.quantizer_window, z)
    mine = tvoc.quantizer_latent(tp["quantizer"], T_VCFG, torch.from_numpy(latent)).numpy()
    assert rel(mine, z) <= LATENT_TOL


@pytest.mark.parametrize("T", [3 * FL + 37, 6 * FL - 100])
def test_dac_encode_matches_jax(vparams, T):
    tp, jp = vparams
    x = audio(T + 1, T)
    got = tvoc.dac_encode(tp, T_VCFG, torch.from_numpy(x))
    want = np.asarray(jvoc.dac_encode(jp, J_VCFG, jnp.asarray(x)))
    assert got.shape == want.shape == (2, T_VCFG.num_codebooks, -(-T // FL))
    padded = np.pad(x, ((0, 0), (0, 0), (0, got.shape[-1] * FL - T)))
    latent = tvoc.encoder_forward(tp["encoder"], T_VCFG, torch.from_numpy(padded)).numpy()
    hold_codes(got, want, tp, latent)


def test_vq_decision_margins_fails_a_wrong_code(vparams):
    """The tie check excuses nothing but a near tie: a code moved to another
    entry at book 1 of one frame fails at TIE_MARGIN, and only a margin
    wider than the gap excuses it."""
    tp, _ = vparams
    z = tvoc.quantizer_latent(tp["quantizer"], T_VCFG, tvoc.encoder_forward(
        tp["encoder"], T_VCFG, torch.from_numpy(audio(5, 4 * FL))))
    codes = tvoc.vq_encode(tp["quantizer"], z)
    bad = codes.clone()
    bad[0, 1, 2] = (bad[0, 1, 2] + 1) % T_VCFG.residual_codebook_size
    assert not testing.vq_decision_margins(codes, codes, tp["quantizer"], z, TIE_MARGIN)[
        "failures"]
    m = testing.vq_decision_margins(bad, codes, tp["quantizer"], z, TIE_MARGIN)
    assert len(m["failures"]) == 1 and "frame 2 book 1" in m["failures"][0]
    assert testing.vq_decision_margins(bad, codes, tp["quantizer"], z, 2.0)["near_ties"] == 1


def test_vq_nearest_matches_jax_on_ties(vparams):
    """Exactly duplicated codebook rows tie: both pick the first of them."""
    tp, jp = vparams
    vq = {k: v for k, v in tp["quantizer"]["residual"][0].items()}
    vq["codebook"] = vq["codebook"].clone()
    vq["codebook"][5] = vq["codebook"][2]
    z = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 4, 9)).astype(np.float32))
    z[:, :, 0] = vq["codebook"][2]
    jvq = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), vq)
    got = tvoc._vq_nearest(vq, z)
    want = np.asarray(jvoc._vq_nearest(jvq, jnp.asarray(z.numpy())))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[:, 0] == 2).all()


def test_encode_shape_contract(vparams):
    """T samples -> ceil(T / frame_length) frames, codes in range (the JAX
    package's ``tests/test_vocoder.py::test_encode_shape_contract``)."""
    tp, _ = vparams
    for T in (3 * FL, 3 * FL + 1, 3 * FL - 1):
        x = np.random.RandomState(3).randn(1, 1, T).astype(np.float32) * 0.1
        codes = tvoc.dac_encode(tp, T_VCFG, torch.from_numpy(x))
        assert codes.shape == (1, T_VCFG.num_codebooks, -(-T // FL))
        assert codes[:, 0].max() < T_VCFG.semantic_codebook_size
        assert codes[:, 1:].max() < T_VCFG.residual_codebook_size
        assert codes.min() >= 0


def test_encode_decode_roundtrip_stability(vparams):
    """encode(decode(codes)) runs and keeps the shape (the JAX package's
    test of the same name)."""
    tp, _ = vparams
    rng = np.random.default_rng(4)
    codes = np.concatenate([rng.integers(0, T_VCFG.semantic_codebook_size, (1, 1, 4)),
                            rng.integers(0, T_VCFG.residual_codebook_size,
                                         (1, T_VCFG.n_residual_codebooks, 4))], axis=1)
    wave = tvoc.dac_decode(tp, T_VCFG, torch.from_numpy(codes))
    again = tvoc.dac_encode(tp, T_VCFG, wave)
    assert again.shape == codes.shape
    assert torch.isfinite(wave).all()


# --- FishTTS.encode_reference and PUT /voices ----------------------------------------


@pytest.fixture(scope="module")
def pair(vparams):
    """(JAX FishTTS, port FishTTS) on the same LM and codec weights."""
    tp, jp = vparams
    jcfg, jlm, jtok, jvcfg, _ = jax_bundle(0)
    jtts = JFishTTS(device="cpu", precision="fp32", warmup=False,
                    _testing_bundle=(jcfg, jlm, jtok, jvcfg, jp))
    cfg, params, tok, vcfg, _ = testing.make_tiny_bundle(0)
    return jtts, FishTTS(device="cpu", precision="fp32", warmup=False,
                         _testing_bundle=(cfg, params, tok, vcfg, tp))


def ref_wav(seed: int, n: int, rate: int = 22050) -> bytes:
    """A WAV at another rate (read_wav resamples it), not a frame multiple."""
    return to_wav_bytes(audio(seed, n, B=1)[0, 0] * 2.5, rate)


def test_encode_reference_matches_jax(pair, vparams):
    jtts, tts = pair
    wav = ref_wav(11, 3 * FL // 2 + 321)
    got, want = tts.encode_reference(wav, "a ref"), jtts.encode_reference(wav, "a ref")
    assert got.text == want.text == "a ref"
    assert got.codes.dtype == want.codes.dtype == np.int64
    assert got.codes.shape == want.codes.shape
    if not np.array_equal(got.codes, want.codes):  # near ties only
        from fish_tts_tpu_torch.synthesizer import vocoder_bucket
        from fish_tts_tpu_torch.utils.audio import read_wav

        x = read_wav(wav)
        padded = np.zeros((1, 1, vocoder_bucket(got.codes.shape[1]) * FL), np.float32)
        padded[0, 0, :len(x)] = x
        latent = tvoc.encoder_forward(vparams[0]["encoder"], T_VCFG, torch.from_numpy(padded))
        n = got.codes.shape[1]
        z = tvoc.quantizer_latent(vparams[0]["quantizer"], T_VCFG, latent)[:, :, :n]
        m = testing.vq_decision_margins(torch.from_numpy(got.codes[None]),
                                        torch.from_numpy(want.codes[None]),
                                        vparams[0]["quantizer"], z, TIE_MARGIN)
        assert not m["failures"], m["failures"]


def test_encode_reference_without_codec_raises():
    cfg, params, tok, vcfg, _ = testing.make_tiny_bundle(3)
    tts = FishTTS(device="cpu", precision="fp32", warmup=False,
                  _testing_bundle=(cfg, params, tok, vcfg, None))
    with pytest.raises(RuntimeError, match="Vocoder not loaded"):
        tts.encode_reference(ref_wav(1, 5000), "x")


@pytest.fixture(scope="module")
def server(pair):
    _, tts = pair
    srv, driver = make_server(tts, host="127.0.0.1", port=0, slots=2, max_queue=8)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv.server_address, tts, driver
    driver.close()
    srv.shutdown()


def request(addr, method, path, body=None):
    conn = http.client.HTTPConnection(*addr, timeout=120)
    conn.request(method, path, body)
    r = conn.getresponse()
    out = (r.status, json.loads(r.read()))
    conn.close()
    return out


def test_put_voice_registers_it(server):
    """``PUT /voices/<name>`` encodes the WAV into the profile that
    ``encode_reference`` gives; ``GET /voices`` lists it; a synthesis with
    that voice answers."""
    addr, tts, _ = server
    wav = ref_wav(12, 2 * FL + 77)
    body = json.dumps({"wav_b64": base64.b64encode(wav).decode(), "text": "my voice"})
    status, out = request(addr, "PUT", "/voices/mine", body)
    want = tts.encode_reference(wav, "my voice")
    assert status == 200 and out == {"voice": "mine", "frames": want.codes.shape[1]}
    assert request(addr, "GET", "/voices") == (200, {"voices": ["mine"]})
    conn = http.client.HTTPConnection(*addr, timeout=120)
    conn.request("POST", "/synthesize", json.dumps(
        {"text": "with my voice", "voice": "mine", "max_new_tokens": 8, "seed": 3}))
    r = conn.getresponse()
    assert r.status == 200 and len(r.read()) > 0
    conn.close()


@pytest.mark.parametrize("body", ["[1]", "{}", json.dumps({"wav_b64": "bm90IGEgd2F2"}),
                                  "not json"])
def test_put_voice_bad_body_answers_400(server, body):
    addr, *_ = server
    status, out = request(addr, "PUT", "/voices/bad", body)
    assert status == 400 and "error" in out
    assert "bad" not in request(addr, "GET", "/voices")[1]["voices"]


def test_handler_without_encoder_answers_501(server):
    """A handler built with ``encode_reference=None`` answers 501, the
    registry unchanged."""
    _, tts, driver = server
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(
        driver, tts.sample_rate, voices={}, encode_reference=None))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        body = json.dumps({"wav_b64": base64.b64encode(ref_wav(1, 3000)).decode()})
        status, out = request(srv.server_address, "PUT", "/voices/x", body)
        assert status == 501 and "encoder" in out["error"]
        assert request(srv.server_address, "GET", "/voices") == (200, {"voices": []})
    finally:
        srv.shutdown()
