"""Seconds from the process's start to the window's opening: the kernels'
build (first run in a checkout only), the weights, the instance and the
warm-up of every shape the mix meets."""


def read(run):
    return run.setup_s
