"""Host milliseconds of a request: its wall time less the time the card
was busy inside it (upload, read-back and resizes on the host, launches),
the mean over the traced window's requests."""

import statistics


def read(run):
    t = run.trace
    spans = t.spans.get("request", []) if t is not None else []
    if not spans:
        return None
    return statistics.fmean((b - a) - t.busy_s(a, b) for a, b in spans) * 1e3
