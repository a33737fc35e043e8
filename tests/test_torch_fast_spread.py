"""The work map of the fast decoder's spread attention (``csrc/fast_decoder.cu``
``attend_spread``: phase 2a of the batched ``"value"`` instantiations),
modelled in plain Python and numpy on the CPU, where no kernel runs.

Unit u = b * H + h is stream b's query head h = j * G + g (KV head j); global
warp w = warp * grid + block takes units w, w + WARPS * grid, ...  Each unit
must be attended exactly once on the grid, cache row ``pos`` of every
(stream, KV head) written exactly once (by its g = 0 unit), and each unit's
output row must land at row b, columns h * Dh of the W_o input, which the
W_o phase stages from the buffer as it lies.  The smoke's phase labels
(``chip_smoke.fast_phase_labels``) must give one label per barrier of the
kernel: the spread instantiations have one more a layer.
"""

import collections

import numpy as np
import pytest

import chip_smoke
from fish_tts_tpu_torch.config import S1_MINI_CONFIG, TINY_CONFIG

WARPS = 16  # csrc/persistent.cuh kWarps
HKV, GROUP, DH = 8, 2, 64  # S1-mini's fast attention: 8 KV heads of 2 query heads, 64 dims


def spread_units(blk: int, warp: int, grid: int, units: int) -> range:
    """The units the warp ``warp`` of block ``blk`` attends (the loop of
    ``attend_spread``)."""
    return range(warp * grid + blk, units, WARPS * grid)


def run_map(B: int, grid: int):
    """Every unit each warp of the grid attends, as (b, j, g) counts, the
    cache rows written, as (b, j) counts, and the obuf the units fill: lane i
    of a unit writes dims (2i, 2i + 1) of its row, tagged (b, h, dim)."""
    H = HKV * GROUP
    attended, cache_rows = collections.Counter(), collections.Counter()
    obuf = np.full(B * H * DH, -1, np.int64)
    for blk in range(grid):
        for warp in range(WARPS):
            for u in spread_units(blk, warp, grid, B * H):
                b = u // H
                h = u - b * H
                j = h // GROUP
                g = h - j * GROUP
                attended[b, j, g] += 1
                if h == j * GROUP:
                    cache_rows[b, j] += 1
                for lane in range(DH // 2):
                    for d in (2 * lane, 2 * lane + 1):
                        obuf[u * DH + d] = (b * H + h) * DH + d
    return attended, cache_rows, obuf


@pytest.mark.parametrize("grid", [1, 7, 132])
@pytest.mark.parametrize("B", [2, 4, 8, 16])
def test_spread_attention_map(B, grid):
    attended, cache_rows, obuf = run_map(B, grid)
    units = [(b, j, g) for b in range(B) for j in range(HKV) for g in range(GROUP)]
    assert sorted(attended) == units and set(attended.values()) == {1}
    assert sorted(cache_rows) == [(b, j) for b in range(B) for j in range(HKV)]
    assert set(cache_rows.values()) == {1}
    # the W_o input (B, H * Dh): row b, columns h * Dh + d hold unit (b, h)'s dim d
    want = np.arange(B * HKV * GROUP * DH).reshape(B, HKV * GROUP * DH)
    np.testing.assert_array_equal(obuf.reshape(B, -1), want)


def kernel_barriers(cfg, batch: int, dequant: str) -> int:
    """The grid-wide barriers of one frame of ``fast_frame_kernel``: per
    position and layer W_qkv, the attention with W_o (two phases in the
    spread instantiations), W_1/W_3 and W_2; position 0's last layer W_qkv
    and the cache row; head and sampling at positions >= 1."""
    attention = 2 if batch >= 2 and dequant != "s8" else 1
    L, K = cfg.n_fast_layer, cfg.num_codebooks
    return (L - 1) * (3 + attention) + 2 + (K - 1) * (L * (3 + attention) + 2)


@pytest.mark.parametrize("dequant", ["value", "s8"])
@pytest.mark.parametrize("B", [1, 16])
def test_phase_labels_count_the_barriers(B, dequant):
    labels = chip_smoke.fast_phase_labels(S1_MINI_CONFIG, B, dequant)
    assert len(labels) == kernel_barriers(S1_MINI_CONFIG, B, dequant)
    # S1-mini: 10 positions of 4 layers; B = 1 and "s8" 176 barriers, the
    # spread instantiations 39 more (one a layer: 3 at position 0, 36 after)
    assert len(labels) == (215 if B == 16 and dequant == "value" else 176)
    spread = B >= 2 and dequant == "value"
    assert ("attention" in labels) == spread == ("W_o + residual" in labels)
    assert ("attention + W_o" in labels) == (not spread)
    tiny = chip_smoke.fast_phase_labels(TINY_CONFIG, B, dequant)
    assert len(tiny) == kernel_barriers(TINY_CONFIG, B, dequant)
