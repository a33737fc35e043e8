"""The slow-stack kernel's share of its roofline in the traced window: the
bound of every call (``counts.slow_stack_call`` at the pool's batch and
the cache rows its live streams held) over the kernel's device time."""

from port_bench import counts, usage


def read(run):
    return usage.roofline(run, "slow_step_kernel", lambda t: counts.slow_stack_call(
        run.config["model"], run.spec["slots"], usage.cache_rows(run, t)))
