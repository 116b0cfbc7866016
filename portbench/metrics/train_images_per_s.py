"""Images trained per second: every image of every step dispatched in the
window (all ranks' for a data-parallel cell), over the window's time, from
its start to the end of its last step on the card."""


def read(run):
    return run.raw["images"] / run.raw["window_s"]
