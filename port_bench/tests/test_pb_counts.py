"""The byte and FLOP functions against the S1-mini counts worked out by hand."""

import json
from pathlib import Path

import pytest

from port_bench import counts
from port_bench.run import config_of

CONFIG = config_of(json.loads(
    (Path(__file__).resolve().parents[1] / "configs" / "s1mini-int8.json").read_text()))
M, V = CONFIG["model"], CONFIG["codec"]


def test_weights_by_hand():
    # 2048x1024 + 1024x1024 + 2 x 4096x1024 + 1024x4096 int8 bytes a slow layer
    assert counts.slow_layer(M) == 15_728_640
    assert M["vocab_size"] * M["dim"] == 159_514_624  # the tied head's int8 rows
    assert M["n_fast_layer"] * counts.fast_layer(M) == 62_914_560


def test_lm_flops_per_frame_by_hand():
    slow = 2 * (28 * 15_728_640 + 159_514_624)
    fast = 2 * (10 * 4 * 15_728_640 + 9 * 1024 * 1024) + 4 * 4 * 16 * 64 * 55
    assert counts.lm_flops_per_frame(M, 0) == slow + fast
    assert counts.lm_flops_per_frame(M, 100) - counts.lm_flops_per_frame(M, 0) == (
        4 * 28 * 100 * 16 * 64)
    assert 2.4e9 < counts.lm_flops_per_frame(M, 500) < 2.6e9


def test_codec_flops_per_frame_by_hand():
    C, D, I = 1024, 1024, 3072
    macs = 10 * 8 * C + 8 * (4 * D * D + 3 * D * I + 2 * 128 * 16 * 64)
    macs += 2 * (C * C + 7 * C + 8 * C * C) + 4 * (C * C + 7 * C + 8 * C * C)
    macs += 4 * 7 * 1024 * 1536
    pos, ch = 4, 1536
    for i, s in enumerate((8, 8, 4, 2)):
        d_in, d_out = ch // 2 ** i, ch // 2 ** (i + 1)
        pos *= s
        macs += pos * (2 * d_in * d_out + 3 * 8 * d_out * d_out)
    macs += 2048 * 7 * 96
    assert counts.codec_flops_per_frame(V) == 2.0 * macs
    assert 6.0e9 < counts.codec_flops_per_frame(V) < 7.0e9


def test_kernel_bounds():
    # B = 1, no cache: the slow stack reads its int8 weights once (about 600 MB)
    slow = counts.slow_stack_call(M, 1, 0)
    assert 0.17e-3 < slow < 0.19e-3
    # each cache row adds 28 layers x K and V x 8 heads x 64 x 2 bytes
    extra = counts.slow_stack_call(M, 1, 1000) - slow
    assert extra == pytest.approx(1000 * 28 * 2 * 8 * 64 * 2 / counts.HBM_BYTES_PER_S)
    fast = counts.fast_decoder_call(M, 16, 16)
    assert 0.019e-3 < fast < 0.025e-3
    assert counts.sampler_call(M, 16) == pytest.approx(
        (16 * 155_776 * 8 + 16 * 11 * 4 + 16 * 16) / counts.HBM_BYTES_PER_S)
