"""The whole step's share of the card's bf16 peak (``usage.mfu_pct``): the
int8 route's cells."""

from port_bench import usage


def read(run):
    return usage.mfu_pct(run)
