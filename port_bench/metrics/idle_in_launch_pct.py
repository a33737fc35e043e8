"""The share of the traced window in which the card was idle while the
thread that ran the program was inside a launch span (its innermost open
call span enqueued device work)."""

from port_bench import program_spans


def read(run):
    return program_spans.idle_pct(run, "launch")
