"""Milliseconds from a streamed call's start to the host holding its first
frames: the mean of the engine's ``engine.first_frames`` spans that ended
in the window."""

from port_bench import program_spans


def read(run):
    return program_spans.mean_ms(run, "engine.first_frames")
