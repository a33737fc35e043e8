"""Milliseconds per serving round the host spent launching the pool codec:
the window's ``serve.codec.launch`` spans over its ``serve.round`` spans."""

from port_bench import program_spans


def read(run):
    return program_spans.per_round_ms(run, "serve.codec.launch")
