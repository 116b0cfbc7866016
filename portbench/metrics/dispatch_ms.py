"""Host milliseconds a step call takes to dispatch (the call into the
program's train step; the run-ahead's waits fall outside it), the mean over
the traced window."""

import statistics


def read(run):
    d = run.raw.get("dispatch_s")
    return statistics.fmean(d) * 1e3 if d else None
