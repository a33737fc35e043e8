"""The share of the traced window in which no operation ran on the card
(the bf16 route's throughput cells)."""

from port_bench import usage


def read(run):
    return usage.idle_pct(run)
