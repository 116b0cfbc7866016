"""The 95th percentile of the latency of every request of the window, each
from its call to its masks on the host."""

import numpy as np


def read(run):
    return float(np.percentile(np.asarray(run.raw["latency_s"]) * 1e3, 95))
