"""The traffic generator: a function of (seed, request index) alone."""

import numpy as np

from port_bench.traffic import GREEDY, Traffic

from conftest import TINY_MIXES

SPEC = {"kind": "serve_open", "rate_per_s": 5.0, "prompt_tokens": [48, 120],
        "frames": [40, 120], "grid": 16, "greedy_every": 4,
        "sampling": {"temperature": 0.7, "top_p": 0.8, "repetition_penalty": 1.1},
        "voices": {"frames": [200, 330, 500, 661], "text_chars": [40, 80]}}
BIG = 2**31 + 12345  # the driver's seeds run past 32 bits


def test_same_seed_same_requests():
    a, b = Traffic(SPEC, BIG, (10, 4096, 1024)), Traffic(SPEC, BIG, (10, 4096, 1024))
    for i in range(40):
        assert a.request(i) == b.request(i)
        assert a.arrival(i) == b.arrival(i)
    for (ta, ca), (tb, cb) in zip(a.voices, b.voices):
        assert ta == tb and np.array_equal(ca, cb)


def test_seeds_differ_in_order_not_in_sizes():
    """Every seed asks for the same sizes each cycle, in its own order."""
    a, b = Traffic(SPEC, 7, (10, 4096, 1024)), Traffic(SPEC, BIG, (10, 4096, 1024))
    ra = [a.request(i) for i in range(32)]
    rb = [b.request(i) for i in range(32)]
    for cycle in range(2):
        part = slice(16 * cycle, 16 * (cycle + 1))
        assert sorted(r.frames for r in ra[part]) == sorted(r.frames for r in rb[part])
        assert sorted(len(r.text) for r in ra[part]) == sorted(len(r.text) for r in rb[part])
    assert [r.frames for r in ra] != [r.frames for r in rb]
    # one cycle of arrivals spans the same time under every seed
    assert np.isclose(a.arrival(15), b.arrival(15))
    assert [a.arrival(i) for i in range(15)] != [b.arrival(i) for i in range(15)]


def test_sizes_lie_in_their_ranges_and_text_is_bytes():
    t = Traffic(SPEC, 3, (10, 4096, 1024))
    for i in range(64):
        r = t.request(i)
        assert 40 <= r.frames <= 120
        assert 48 <= len(r.text.encode()) <= 120 and r.text.isascii()
        assert r.voice in range(4)
        assert r.greedy == (i % 4 == 0)
        assert r.sampling == (GREEDY if r.greedy else SPEC["sampling"])
    codes = t.voices[3][1]
    assert codes.shape == (10, 661) and codes[0].max() < 4096 and codes[1:].max() < 1024


def test_open_loop_due_times_do_not_depend_on_service():
    """Arrivals are fixed from the seed before any request is served, and
    one cycle's gaps average 1 / rate."""
    t = Traffic(SPEC, 11, (10, 4096, 1024))
    due = [t.arrival(i) for i in range(48)]
    assert all(b > a for a, b in zip(due, due[1:]))
    assert np.isclose(due[15] / 16, 1 / SPEC["rate_per_s"], rtol=0.05)
    again = Traffic(SPEC, 11, (10, 4096, 1024))
    assert [again.arrival(i) for i in reversed(range(48))] == due[::-1]


def test_tiny_mixes_are_valid():
    for spec in TINY_MIXES.values():
        t = Traffic(spec, 5, (4, 48, 24))
        assert t.request(0).greedy
