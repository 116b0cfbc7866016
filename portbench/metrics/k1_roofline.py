"""K1 (InstanceNorm + LeakyReLU forward) against its memory bound: the
bytes of its calls in the window's forwards (input read once, output written
once, from the configuration's shapes) at 3.35 TB/s, over its device time
in the trace."""

from pb import counts


def read(run):
    t = run.trace
    spent = t.kind_s("K1") if t is not None else 0.0
    if spent <= 0:
        return None
    nbytes = counts.k1_bytes(run.cfg, run.traffic["batch"]) * run.raw["forwards"]
    return 100.0 * nbytes / counts.HBM_BYTES_PER_S / spent
