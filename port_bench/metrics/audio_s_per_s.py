"""Seconds of PCM delivered to the callers in the window, over the window's
seconds (the window ends with the last round that started in it): the
int8 route's cells."""

from port_bench import usage


def read(run):
    return usage.audio_s_per_s(run)
