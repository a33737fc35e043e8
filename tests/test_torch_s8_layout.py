"""The index arithmetic and the scale path of the fast decoder's ``"s8"``
kernel (``csrc/persistent.cuh``: ``gemv_partials_s8``, ``row_value_s8``,
``store_rows_s8``, ``fold_scales_s8``, ``s8_quantize4``), modelled in numpy on
the CPU, where no kernel runs.

- The GEMV: each lane's loads as the kernel makes them (16 bytes at 16 t of
  a 64-byte chunk, of weight row 8 tile + g and of stream rows g and g + 8,
  bytes 0-7 the first k-step, 8-15 the second), placed into the
  ``mma.sync.m16n8k32`` s8 operands by the PTX ISA's fragment layout, the
  product's D handed back to the lanes by that layout, stored and folded as
  the kernel does; the result must equal an int64 matmul exactly.
- The scales: each block of a 132-block grid publishes the max |value| of
  the rows it owns (``owned()``), a reader folds them, and the scale must
  equal ``ops.fast_decoder.s8_scaled``'s bit for bit.
- The quotient: ``round_half_even(x / sc)`` without a division
  (``s8_fast``: x times the reciprocal; ``s8_near``: a tie near a half-integer decided
  exactly), against the plain version's ``torch.round(x / sc)`` on a
  seeded sweep and at every half-integer tie.

All of it is exact integer or bit comparison: no tolerance.
"""

import numpy as np
import pytest
import torch

from fish_tts_tpu_torch.ops.fast_decoder import s8_scaled
from test_torch_stream import one_thread  # noqa: F401 (an autouse fixture)

GRID = 132  # one block per SM of an H100
WARPS = 16  # csrc/persistent.cuh kWarps
# S1-mini's fast GEMVs (N, K, matrices, grid): W_qkv, W_o, W_1/W_3, W_2, the
# head; a K that is not a multiple of 64 (the last chunk partly past K); and
# fewer rows than blocks (a block may own none), as at the tiny config
PHASES = {"wqkv": (2048, 1024, 1, GRID), "wo": (1024, 1024, 1, GRID),
          "w13": (4096, 1024, 2, GRID), "w2": (1024, 4096, 1, GRID),
          "head": (1024, 1024, 1, GRID), "k_tail": (40, 48, 2, 3), "few_rows": (24, 64, 2, GRID)}
BATCHES = (1, 4, 8, 16)


def owned(n: int, blk: int, grid: int = GRID) -> tuple[int, int]:
    """``persistent.cuh::owned``: the rows [r0, r1) block ``blk`` owns."""
    return blk * n // grid, (blk + 1) * n // grid


def splits(tiles: int) -> int:
    """``s8_splits``: warps per tile, a power of two."""
    s = 1
    while s < WARPS and tiles * s * 2 <= WARPS:
        s *= 2
    return s


LANE = np.arange(32)
G, T4 = LANE // 4, LANE % 4  # a lane's group g and thread-in-group t
R4, J4 = np.arange(4)[:, None], np.arange(4)[None, :]
R2 = np.arange(2)[:, None]


def a_fragment(regs: np.ndarray) -> np.ndarray:
    """The 16 x 32 A operand from its fragment (lanes, 4 registers, 4 bytes),
    by the PTX ISA's layout for ``.s8`` (m16n8k32): register r, byte j of
    lane (g, t) is row g + 8 (r % 2), column 4 t + j + 16 (r // 2)."""
    a = np.zeros((16, 32), np.int64)
    a[G[:, None, None] + 8 * (R4 % 2), 4 * T4[:, None, None] + J4 + 16 * (R4 // 2)] = regs
    return a


def b_fragment(regs: np.ndarray) -> np.ndarray:
    """The 32 x 8 B operand from its fragment (lanes, 2 registers, 4 bytes):
    register r, byte j of lane (g, t) is row 4 t + j + 16 r, column g."""
    b = np.zeros((32, 8), np.int64)
    b[4 * T4[:, None, None] + J4 + 16 * R2, np.broadcast_to(G[:, None, None], (32, 2, 4))] = regs
    return b


def d_fragment(d: np.ndarray) -> np.ndarray:
    """The 16 x 8 s32 D handed to the lanes (lanes, 4): register r of lane
    (g, t) is row g + 8 (r // 2), column 2 t + r % 2."""
    r = np.arange(4)[None, :]
    return d[G[:, None] + 8 * (r // 2), 2 * T4[:, None] + r % 2]


def kernel_gemv(xq: np.ndarray, slot: np.ndarray, nr: int, nmat: int, K: int,
                maxb: int) -> tuple[np.ndarray, int]:
    """``gemv_partials_s8`` for one block: ``xq`` (B, K) the staged rows,
    ``slot`` the block's weight rows as the bulk copy lays them (W_1's nr
    rows, then W_3's, then whatever bytes follow, K each).  Returns
    (part (tasks, maxb, 8), S)."""
    B = xq.shape[0]
    nt = (nr + 7) // 8
    T = nmat * nt
    S = splits(T)
    nc = (K + 63) // 64
    # the lanes read zeros past K, and at stream rows >= B
    x16 = np.zeros((16, nc * 64 + 64), np.int64)
    x16[:B, :K] = xq
    wpad = np.zeros((slot.shape[0], nc * 64 + 64), np.int64)
    wpad[:, :K] = slot
    part = np.zeros((T * S, maxb, 8), np.int64)
    for task in range(T * S):
        tile, sg = divmod(task, S)
        row = tile * 8 + G if tile < nt else nr + (tile - nt) * 8 + G
        d = np.zeros((32, 4), np.int64)
        for c in range(sg * nc // S, (sg + 1) * nc // S):
            cols = (c * 64 + 16 * T4)[:, None] + np.arange(16)
            w = wpad[row[:, None], cols]
            lo = x16[G[:, None], cols]
            hi = x16[G[:, None] + 8, cols] if maxb > 8 else np.zeros_like(lo)
            for step in range(2):  # bytes 0-7, then 8-15
                o = 8 * step
                a_regs = np.stack([lo[:, o:o + 4], hi[:, o:o + 4], lo[:, o + 4:o + 8],
                                   hi[:, o + 4:o + 8]], axis=1)
                b_regs = np.stack([w[:, o:o + 4], w[:, o + 4:o + 8]], axis=1)
                d += d_fragment(a_fragment(a_regs) @ b_fragment(b_regs))
        for lane in range(32):
            g, t = divmod(lane, 4)
            if g < B:
                part[task, g, 2 * t:2 * t + 2] = d[lane, 0:2]
            if maxb > 8 and g + 8 < B:
                part[task, g + 8, 2 * t:2 * t + 2] = d[lane, 2:4]
    return part, S


def kernel_row(part: np.ndarray, S: int, nr: int, j: int, b: int, up: bool) -> int:
    """``row_value_s8``'s fold: row j (of W_3 when ``up``) of stream b, the
    splits summed in order."""
    tile = j // 8 + ((nr + 7) // 8 if up else 0)
    return int(sum(part[tile * S + sg, b, j % 8] for sg in range(S)))


def int8s(rng, shape) -> np.ndarray:
    """Random int8 values with both extremes, -128 and 127, in every row."""
    v = rng.integers(-128, 128, size=shape, dtype=np.int64)
    v[..., 0], v[..., -1] = -128, 127
    return v


def blocks_with_each_count(n: int, grid: int = GRID) -> list[int]:
    """The first block of each owned-row count, and the last block."""
    seen, out = set(), []
    for blk in range(grid):
        r0, r1 = owned(n, blk, grid)
        if r1 - r0 not in seen:
            seen.add(r1 - r0)
            out.append(blk)
    return out + ([grid - 1] if grid - 1 not in out else [])


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("phase", PHASES)
def test_mma_fragments_give_the_int64_product(phase, B):
    """Every owned row of every stream at S1-mini widths (and a K that is
    not a multiple of 64, the last chunk partly past K) equals the int64
    product, for blocks with each ragged owned-row count."""
    N, K, nmat, grid = PHASES[phase]
    maxb = 1 if B <= 1 else 4 if B <= 4 else 16  # the instantiation the entry picks
    rng = np.random.default_rng(1000 * B + len(phase))
    x = int8s(rng, (B, K))
    mats = [int8s(rng, (N, K)) for _ in range(nmat)]
    for blk in blocks_with_each_count(N, grid):
        r0, r1 = owned(N, blk, grid)
        nr = r1 - r0
        # the slot: the owned rows of each matrix, then other bytes
        slot = np.concatenate([m[r0:r1] for m in mats] + [int8s(rng, (16, K))])
        part, S = kernel_gemv(x, slot, nr, nmat, K, maxb)
        for m, mat in enumerate(mats):
            want = x @ mat[r0:r1].T
            got = np.array([[kernel_row(part, S, nr, j, b, up=m == 1) for j in range(nr)]
                            for b in range(B)], dtype=np.int64).reshape(B, nr)
            np.testing.assert_array_equal(got, want, err_msg=f"block {blk} matrix {m}")


def publish_and_fold(y: torch.Tensor, grid: int = GRID) -> torch.Tensor:
    """``store_rows_s8``'s published maxima and ``fold_scales_s8``: each block
    takes max(0, |y|) of the columns it owns as int32 bits (atomicMax), the
    reader folds the blocks' maxima and divides by 127."""
    B, n = y.shape
    pub = torch.zeros((grid, B), dtype=torch.int32)
    bits = torch.clamp(y.abs(), min=0.0).view(torch.int32)
    for blk in range(grid):
        r0, r1 = owned(n, blk, grid)
        if r1 > r0:
            pub[blk] = bits[:, r0:r1].amax(dim=1)
    m = pub.amax(dim=0).view(torch.float32)
    return (torch.clamp(m, min=1e-30) / 127)[:, None]


@pytest.mark.parametrize("n", [1024, 4096])
def test_published_maxima_give_the_plain_scale(n):
    """The folded scale equals ``s8_scaled``'s bit for bit: random rows of
    several magnitudes, an all-zero row (the 1e-30 floor), single-nonzero
    rows at the first, a middle and the last lane, and negative maxima."""
    rng = np.random.default_rng(n)
    rows = [rng.standard_normal(n) * s for s in (1e-3, 1.0, 37.5, 3e4)]
    rows.append(np.zeros(n))
    for lane, v in ((0, 2.5), (n // 2 + 3, -7.0), (n - 1, 1e-20)):
        r = np.zeros(n)
        r[lane] = v
        rows.append(r)
    r = rng.standard_normal(n)
    r[n // 3] = -50.0  # the largest magnitude negative
    rows.append(r)
    y = torch.from_numpy(np.stack(rows).astype(np.float32))
    want = s8_scaled(y)[1]
    got = publish_and_fold(y)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # the bits of non-negative floats order as the floats
    a = torch.from_numpy(np.abs(rng.standard_normal(4096)).astype(np.float32))
    assert torch.equal(a.view(torch.int32).amax().view(torch.float32), a.amax())


F32 = np.float32


def s8_round(x: np.ndarray, sc: np.ndarray, r: np.ndarray) -> np.ndarray:
    """``persistent.cuh::s8_fast`` / ``s8_near`` in float32, as int8: q = x *
    r; away from a half-integer the low byte of q + 1.5 * 2^23; within 2^-14
    of one, h, the tie decided from d = fma(-h, sc, x) (here in float64,
    exact as the fma is) scaled by 2^(24 - k), k = the exponent of h."""
    kr, near_at = F32(12582912.0), F32(0.5 - 2.0 ** -14)
    x, sc, r = (np.asarray(v, F32) for v in np.broadcast_arrays(x, sc, r))
    q = x * r
    t = q + kr
    n0 = t - kr
    near = np.abs(q - n0) >= near_at
    h = n0 + np.copysign(F32(0.5), q - n0)
    d = (x.astype(np.float64) - h.astype(np.float64) * sc.astype(np.float64)).astype(F32)
    k = ((h.view(np.uint32) >> 23) & 0xFF).astype(np.int64) - 127
    s = d * np.copysign(((151 - k).astype(np.uint32) << 23).view(F32), h)
    tie = (s <= sc) & (s >= -sc)
    n = np.where(tie, (h + kr) - kr, np.where(d > 0, h + F32(0.5), h - F32(0.5)))
    out = np.where(near, n + kr, t).astype(F32)
    return (out.view(np.uint32) & 0xFF).astype(np.uint8).view(np.int8)


def ulps(v: np.ndarray, n: int) -> np.ndarray:
    """v moved n float32 steps (n may be negative)."""
    for _ in range(abs(n)):
        v = np.nextafter(v, F32(np.inf if n > 0 else -np.inf))
    return v


@pytest.mark.parametrize("r_ulps", [-2, -1, 0, 1, 2])
def test_quotient_without_division_on_a_sweep(r_ulps):
    """``s8_round`` against the plain version's ``torch.round(x / sc)`` on
    seeded rows of every magnitude (their scales from ``s8_scaled``), with
    the reciprocal off by up to two float32 steps (the kernel's is within
    one)."""
    rng = np.random.default_rng(100 + r_ulps)
    x = (rng.standard_normal((96, 4096)) * 10.0 ** rng.uniform(-8, 8, (96, 1))).astype(F32)
    x[:8, :] = rng.integers(-127, 128, (8, 4096)).astype(F32) * F32(2.0 ** -5)  # exact ties
    x[8] = 0.0  # the 1e-30 floor
    x[9, 1:] = 0.0
    q, sc = s8_scaled(torch.from_numpy(x))
    want = torch.round(q).to(torch.int8).numpy()
    r = ulps(F32(1.0) / sc.numpy(), r_ulps)
    np.testing.assert_array_equal(s8_round(x, sc.numpy(), r), want)


@pytest.mark.parametrize("r_ulps", [-2, 0, 2])
def test_quotient_without_division_at_the_ties(r_ulps):
    """The same at and around every half-integer h of [-126.5, 126.5]: x =
    the float32 nearest h * sc and its neighbours three steps either way,
    for seeded scales m / 127 of every magnitude (down to the 1e-30 floor)
    and for scales that are powers of two, where x / sc == h exactly."""
    rng = np.random.default_rng(200 + r_ulps)
    m = (10.0 ** rng.uniform(-30, 30, 512)).astype(F32)
    sc = np.concatenate([m / F32(127), F32(2.0) ** np.arange(-100, 100, 7).astype(F32),
                         [F32(1e-30) / F32(127)]]).astype(F32)
    h = (np.arange(-126, 127, dtype=F32) + F32(0.5))
    x0 = (h[None, :].astype(np.float64) * sc[:, None]).astype(F32)
    x = np.stack([ulps(x0, n) for n in range(-3, 4)])
    scb = np.broadcast_to(sc[None, :, None], x.shape)
    want = torch.round(torch.from_numpy(x) / torch.from_numpy(np.ascontiguousarray(scb)))
    r = ulps(F32(1.0) / scb, r_ulps)
    np.testing.assert_array_equal(s8_round(x, scb, r), want.to(torch.int8).numpy())
