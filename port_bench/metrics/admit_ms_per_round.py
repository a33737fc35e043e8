"""Milliseconds of admission per serving round: the window's ``serve.admit``
spans (each admitted request's scratch, prefill launch, install and
first-frame copy) over its ``serve.round`` spans."""

from port_bench import program_spans


def read(run):
    return program_spans.per_round_ms(run, "serve.admit")
