"""Milliseconds a request waited in the serving queue: the mean of the
program's ``serve.queue`` spans (submission to the start of the admitting
round's admission) over the requests admitted in the window."""

from port_bench import program_spans


def read(run):
    return program_spans.mean_ms(run, "serve.queue")
