"""Seconds of decode-graph captures (the ``graph.capture`` spans, pool and
engine alike) before the window opened: the part of set-up they take."""

from port_bench import program_spans


def read(run):
    return program_spans.before_window_s(run, "graph.capture")
