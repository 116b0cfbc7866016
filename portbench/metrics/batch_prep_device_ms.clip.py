"""Device milliseconds a batch of the kernels launched while the online
augmentation and the tower prepare it (the harness's span around the
wrapped iterator's next())."""


def read(run):
    t = run.trace
    spans = t.spans.get("batch_prep", []) if t is not None else []
    if not spans:
        return None
    spent = t.launched_in_s("batch_prep")
    return spent / len(spans) * 1e3 if spent > 0 else None
