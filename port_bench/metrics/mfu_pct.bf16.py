"""The whole step's share of the card's bf16 peak (``usage.mfu_pct``): the
bf16 route's cells."""

from port_bench import usage


def read(run):
    return usage.mfu_pct(run)
