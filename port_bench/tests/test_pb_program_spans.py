"""The readers of the program's spans (``program_spans.py``) on a synthetic
timeline, span list and registry snapshots: the idle split partitions the
window's idle share, resolves nesting to the innermost call span, leaves
request spans and other threads out; a missing span gives None."""

import pytest

from port_bench import program_spans, run
from port_bench.trace import Timeline

MAIN, OTHER = 1, 2


def sp(seq, name, kind, start, end, parent=None, rid=None, thread=MAIN):
    return (seq, name, kind, start, end, parent, rid, thread)


# busy [1, 2], [4, 5], [7, 7.5] in a window [0, 10]: idle 0-1, 2-4, 5-7, 7.5-10
TIMELINE = Timeline([("k", 1.0, 2.0), ("k", 4.0, 5.0), ("k", 7.0, 7.5)], 0.0, 10.0)
SPANS = [
    sp(0, "serve.round", "host", 0.5, 6.0),               # program 0.5-1.5, 3.5-6
    sp(1, "serve.lm.launch", "launch", 1.5, 3.5, parent=0),  # launch, except:
    sp(2, "graph.capture", "host", 2.5, 3.0, parent=1),     # program (innermost)
    sp(3, "serve.queue", "request", 0.0, 9.0, parent=0, rid=4),  # no part in the split
    sp(4, "serve.prepare", "host", 8.0, 9.0, thread=OTHER),  # another thread
    sp(5, "engine.decode.launch", "launch", 6.5, 9.0),      # launch
]


def test_the_idle_split_partitions_the_idle_share_by_the_innermost_span():
    split = program_spans.idle_split(TIMELINE, SPANS)
    # idle 0-0.5 outside, 0.5-1 program; 2-2.5 launch, 2.5-3 program, 3-3.5
    # launch, 3.5-4 program; 5-6 program, 6-6.5 outside, 6.5-7 launch; 7.5-9
    # launch, 9-10 outside
    assert split == pytest.approx({"launch": 10 * (0.5 + 0.5 + 0.5 + 1.5),
                                   "program": 10 * (0.5 + 0.5 + 0.5 + 1.0),
                                   "outside": 10 * (0.5 + 0.5 + 1.0)})
    idle = 100 * (1 - TIMELINE.busy_s() / TIMELINE.window_s)
    assert sum(split.values()) == pytest.approx(idle, abs=1e-12)


def test_spans_past_the_window_are_cut_at_its_edges():
    tl = Timeline([("k", 1.0, 2.0)], 0.0, 3.0)
    split = program_spans.idle_split(tl, [sp(0, "serve.round", "host", -5.0, 0.25),
                                          sp(1, "x", "wait", 2.5, 9.0)])
    assert split == pytest.approx({"launch": 0.0, "program": 100 * 0.75 / 3,
                                   "outside": 100 * 1.25 / 3})


def test_the_program_thread_is_the_one_with_most_outermost_time():
    spans = [sp(0, "a", "host", 0.0, 1.0, thread=OTHER), sp(1, "b", "host", 2.0, 5.0),
             sp(2, "c", "request", 0.0, 9.0, thread=OTHER)]
    assert program_spans.program_thread(spans) == MAIN
    assert program_spans.program_thread([sp(0, "q", "request", 0.0, 1.0)]) is None
    assert program_spans.idle_split(TIMELINE, []) is None


def test_a_fully_busy_window_has_no_idle_to_split():
    tl = Timeline([("k", 0.0, 10.0)], 0.0, 10.0)
    assert program_spans.idle_split(tl, SPANS) == {"launch": 0.0, "program": 0.0,
                                                   "outside": 0.0}


def _run(before, after, timeline=None):
    return run.Run(phases=(before, after), timeline=timeline, t0=0.0, t1=10.0)


def phase(total_s, count):
    return {"total_s": total_s, "count": count, "mean_ms": 0.0}


def test_the_aggregate_readers_difference_the_window_snapshots():
    before = {"serve.round": phase(1.0, 10), "serve.admit": phase(0.2, 4),
              "graph.capture": phase(3.5, 7)}
    after = {"serve.round": phase(3.0, 30), "serve.admit": phase(0.6, 9),
             "serve.queue": phase(0.5, 5), "graph.capture": phase(3.5, 7)}
    r = _run(before, after)
    read = {name: run.reader(name)(r) for name in (
        "admit_ms_per_round", "queue_wait_ms", "graph_capture_s", "lm_launch_ms_per_round",
        "codec_launch_ms_per_round", "first_frames_ms")}
    assert read == pytest.approx({"admit_ms_per_round": 0.4 / 20 * 1e3,
                                  "queue_wait_ms": 0.5 / 5 * 1e3, "graph_capture_s": 3.5,
                                  "lm_launch_ms_per_round": None,
                                  "codec_launch_ms_per_round": None, "first_frames_ms": None})


def test_a_missing_phase_or_ring_gives_none():
    r = _run({}, {})
    for name in ("queue_wait_ms", "admit_ms_per_round", "lm_launch_ms_per_round",
                 "codec_launch_ms_per_round", "first_frames_ms", "graph_capture_s",
                 "idle_in_launch_pct", "idle_in_program_pct", "idle_outside_pct"):
        assert run.reader(name)(r) is None, name
    # rounds recorded, but none in the window
    r = _run({"serve.round": phase(1.0, 3), "serve.admit": phase(0.1, 1)},
             {"serve.round": phase(1.0, 3), "serve.admit": phase(0.1, 1)})
    assert run.reader("admit_ms_per_round")(r) is None


def test_the_idle_readers_read_the_ring(monkeypatch):
    monkeypatch.setattr(program_spans, "ring", lambda t0, t1: SPANS)
    r = _run({}, {}, TIMELINE)
    got = [run.reader(f"idle_{p}_pct")(r) for p in ("in_launch", "in_program", "outside")]
    assert got == pytest.approx([30.0, 25.0, 20.0])
    monkeypatch.setattr(program_spans, "ring", lambda t0, t1: None)
    assert run.reader("idle_outside_pct")(_run({}, {}, TIMELINE)) is None
