"""Milliseconds per serving round the host spent launching the pool's LM
chunk: the window's ``serve.lm.launch`` spans (resize, graph replays or
the eager loop, the chunk's copy) over its ``serve.round`` spans."""

from port_bench import program_spans


def read(run):
    return program_spans.per_round_ms(run, "serve.lm.launch")
