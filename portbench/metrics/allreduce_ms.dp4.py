"""Device milliseconds a step of the NCCL kernels (DDP's gradient
all-reduce and the loss's reductions), the mean over the ranks."""


def read(run):
    t = run.trace
    steps = run.raw.get("steps", 0)
    if t is None or not steps:
        return None
    spent = t.kind_s("nccl")
    return spent / steps * 1e3 if spent > 0 else None
