"""Milliseconds per call of the engine's "prefill" span (the prompt's
prefill and the first chunk), from ``FishTTS.get_metrics()`` at the
window's opening and close."""


def read(run):
    before, after = (p.get("prefill", {"total_s": 0.0, "count": 0}) for p in run.phases)
    n = after["count"] - before["count"]
    return (after["total_s"] - before["total_s"]) / n * 1e3 if n > 0 else None
