"""The share of the traced window in which the card was idle while the
thread that ran the program was in no call span of the program (its
caller's code)."""

from port_bench import program_spans


def read(run):
    return program_spans.idle_pct(run, "outside")
