"""Images served per second: every image of every request of the window,
its mask back at its original size on the host, over the window's time."""


def read(run):
    return run.raw["images"] / run.raw["window_s"]
