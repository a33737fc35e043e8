"""A configuration brings its own LM reference and weight draw, and the
harness refuses one whose model its reference does not compute.  These
drive the whole run on the CPU at tiny widths (the look for a card
skipped)."""

import copy
import hashlib
import json
import sys

import pytest
import torch

from port_bench import check, run, weights
from port_bench.reference import dual_ar, prompt

import qk_norm_reference
from conftest import TINY_MIXES

SEED = 2**31 + 11
# weights.lm's trees for tiny_config.json before configurations could name
# a reference (digest below): (seed, dtype, digest)
TINY_DIGESTS = [
    (5, torch.float32, "4a4aefbc69b89aab7ac84710c9948d2f65b0ca82784ebfafbf56cf0049f415e2"),
    (2**33 + 17, torch.bfloat16,
     "b3ff55d7ef8a332e1d2a5ee30b725ce4847c30f7ef27caa4b89c0b6f59d270a2"),
]


def digest(tree) -> str:
    """A sha256 over every leaf of ``tree``: its path, dtype, shape and
    bytes, in the order of the sorted paths."""
    h = hashlib.sha256()

    def walk(path: tuple, node) -> None:
        if isinstance(node, dict):
            for k in sorted(node, key=str):
                walk((*path, k), node[k])
        elif isinstance(node, list):
            for i, x in enumerate(node):
                walk((*path, i), x)
        else:
            t = node.detach().contiguous().cpu()
            h.update(repr((path, str(t.dtype), tuple(t.shape))).encode())
            h.update(t.view(torch.uint8).numpy().tobytes())

    walk((), tree)
    return h.hexdigest()


@pytest.mark.parametrize("seed,dtype,want", TINY_DIGESTS)
def test_tiny_tree_is_the_one_drawn_before(tiny_config, seed, dtype, want):
    cfg = run.config_of(tiny_config)
    ids = prompt.ids(cfg["model"]["codebook_size"])
    assert digest(weights.lm(cfg["model"], seed, ids.semantic_begin, "cpu", dtype)) == want
    if dtype == torch.float32:  # the run's own draw, through the reference's lookup
        assert digest(run.lm_weights(cfg, seed, ids, "cpu")) == want


@pytest.mark.parametrize("key,value", [
    ("attention_qk_norm", True), ("fast_attention_qk_norm", True), ("attention_qkv_bias", True),
    ("fast_attention_o_bias", True), ("scale_codebook_embeddings", True),
    ("tie_word_embeddings", False), ("model_type", "other"), ("num_experts", 8)])
def test_a_flag_the_reference_does_not_compute_is_refused(tiny_config, monkeypatch, key, value):
    config = copy.deepcopy(tiny_config)
    config["model"][key] = value

    def built(*args, **kw):
        raise AssertionError("the program was built")

    monkeypatch.setattr(run, "build_program", built)
    with pytest.raises(ValueError, match=key):
        run.run_cell(run.manifest(), {"name": "int8-solo-stream", "chips": 1}, SEED, 2.0, False,
                     device="cpu", config=config, traffic_spec=TINY_MIXES["stream_closed"])


def test_a_flag_left_out_is_refused(tiny_config):
    config = copy.deepcopy(tiny_config)
    del config["model"]["scale_codebook_embeddings"]
    with pytest.raises(ValueError, match="scale_codebook_embeddings left out"):
        check.refuse(config)


def test_a_named_reference_judges_what_it_computes(tiny_config, monkeypatch):
    """A q/k-norm model under the fixture reference that computes it is
    correct; the same served codes, judged without the q/k-norm, are not."""
    monkeypatch.setitem(sys.modules, "port_bench.reference.qk_norm_test", qk_norm_reference)
    config = copy.deepcopy(tiny_config)
    config["model"]["attention_qk_norm"] = True
    config["reference"] = "qk_norm_test"
    seen = []
    inner = check.judge

    def spy(*args):
        seen.append(args)
        return inner(*args)

    monkeypatch.setattr(check, "judge", spy)
    res = run.run_cell(run.manifest(), {"name": "int8-solo-stream", "chips": 1}, SEED, 2.0,
                       False, device="cpu", config=config,
                       traffic_spec=TINY_MIXES["stream_closed"])
    assert res["correct"], res["checks"]
    greedy, sampled, traffic, cfg, ref, _, dev = seen[0]
    assert isinstance(ref.lm, qk_norm_reference.DualAR)
    params = run.lm_weights(cfg, SEED, ref.ids, dev)
    assert params["layers"]["q_norm"].shape == (cfg["model"]["n_layer"], cfg["model"]["head_dim"])
    plain = copy.copy(ref)
    plain.lm = dual_ar.DualAR(params, cfg["model"], ref.ids, cfg["precision"])
    got, _ = inner(greedy, sampled, traffic, cfg, plain, {}, dev)
    ok, checks = check.verdict(got, cfg["limits"])
    assert not ok, checks


def test_every_configuration_is_computed_by_its_reference():
    man = run.manifest()
    for c in man["configs"]:
        check.refuse(json.loads((run.ROOT / c["file"]).read_text()))
