"""Device operations in the traced window per LM frame delivered in it:
the bf16 route's cells."""

from port_bench import usage


def read(run):
    return usage.ops_per_frame(run)
