"""``audio_s_per_s`` on the bf16 route's cells, kept apart because that
route's runs spread wider (its own bound)."""

from port_bench import usage


def read(run):
    return usage.audio_s_per_s(run)
