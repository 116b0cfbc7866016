"""Set-up time: from the start of the process (imports included) to the
start of the window: the model built and loaded, the inputs staged, the
kernels built on a checkout's first run, and the warm-up calls."""


def read(run):
    return run.raw["setup_s"]
