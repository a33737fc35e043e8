"""Milliseconds per serving round: the window over the ``step()`` calls the
harness made in it (its own host span around each)."""


def read(run):
    n = sum(1 for name, a, b in run.spans if name == "step" and run.t0 <= a and b <= run.t1)
    return run.window_s / n * 1e3 if n else None
