"""The fast-decoder kernel's share of its roofline in the traced window
(``counts.fast_decoder_call`` at the pool's batch per call)."""

from port_bench import counts, usage


def read(run):
    return usage.roofline(run, "fast_frame_kernel", lambda t: counts.fast_decoder_call(
        run.config["model"], run.spec["slots"], usage.WINDOW))
