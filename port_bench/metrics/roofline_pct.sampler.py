"""The slow-token sampler kernel's share of its roofline in the traced
window (``counts.sampler_call`` at the pool's batch per call)."""

from port_bench import counts, usage


def read(run):
    return usage.roofline(run, "sample_slow_kernel", lambda t: counts.sampler_call(
        run.config["model"], run.spec["slots"]))
