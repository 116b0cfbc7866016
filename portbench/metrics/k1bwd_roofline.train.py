"""K1's backward (InstanceNorm + LeakyReLU) against its memory bound: the
bytes of its calls in the window's steps (x and dy read once, dx written
once, from the configuration's shapes) at 3.35 TB/s, over its device time
in the trace."""

from pb import counts


def read(run):
    t = run.trace
    spent = t.kind_s("K1bwd") if t is not None else 0.0
    if spent <= 0:
        return None
    nbytes = counts.k1bwd_bytes(run.cfg, run.traffic["batch"]) * run.raw["steps"]
    return 100.0 * nbytes / counts.HBM_BYTES_PER_S / spent
