"""The reduction of a ``torch.profiler`` trace to device time.

The arithmetic copies ``unet_implementations_tpu_torch/utils/profiling.py``:
the union of the device's work intervals (``_busy_us``), what counts as work
(kernels, copies, fills; not the span the profiler also draws on the device
for a host range: ``_is_work``), and the kinds of kernels by name
(``KINDS``). Everything is read from the profiler's raw events, on one
clock for the host and the device.

Host spans are ``record_function`` ranges whose names start with
``portbench.``: the window (``portbench.window``) and the harness's calls
into the program's layers.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, Iterable, List, Optional, Tuple

import torch

PREFIX = "portbench."
WINDOW = PREFIX + "window"
# A traced run profiles this much of its window (the rest is not run).
TRACE_SECONDS = 8.0

KINDS = (
    ("K1bwd", (("in_bwd_",),)),
    ("K1", (("in_stats_kernel",), ("in_finalize_kernel",), ("in_apply_kernel",))),
    ("K2b", (("upsample2x_kernel", "true>"),)),
    ("K2a", (("upsample2x_kernel",),)),
    ("K3", (("s2d_conv_",),)),
    ("K4", (("winograd_s2d_",),)),
    ("fp8conv", (("fp8_conv",),)),
    ("nccl", (("nccl",),)),
    ("convolution", tuple((k,) for k in ("conv", "cudnn", "xmma", "gemm", "implicit",
                                         "cutlass", "wgrad", "dgrad"))),
    ("concat", (("CatArray",), ("cat_",))),
    ("optimizer", (("multi_tensor_apply",),)),
    ("reduction", (("reduce_kernel",),)),
    ("copy", (("Memcpy",), ("memcpy",))),
    ("fill", (("Memset",), ("memset",))),
)


def kind_of(name: str) -> str:
    for kind, alternatives in KINDS:
        if any(all(k in name for k in keys) for keys in alternatives):
            return kind
    return "other"


def busy(intervals: Iterable[Tuple[float, float]]) -> float:
    """The length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for lo, hi in sorted(intervals):
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total


@contextmanager
def span(name: str):
    """A host range in the trace (a no-op cost when the profiler is off)."""
    with torch.profiler.record_function(PREFIX + name):
        yield


def profiler(device: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


class Trace:
    """Device records and host spans of one profile, times in seconds on the
    profiler's clock.

    ``work``: (start, end, name, launch) of each device work record, launch
    being the start of the host op that launched it (None where unknown).
    ``spans``: name (without the prefix) -> [(start, end)] of the harness's
    ranges. ``host``: (start, end, name) of the host's ops, for labelling
    idle gaps."""

    def __init__(self, events):
        cpu = torch.autograd.DeviceType.CPU
        starts: Dict[int, float] = {}
        self.spans: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
        self.host: List[Tuple[float, float, str]] = []
        device = []
        for e in events:
            name = e.name()
            lo, hi = e.start_ns() / 1e9, e.end_ns() / 1e9
            if e.device_type() == cpu:
                if name.startswith(PREFIX):
                    self.spans[name[len(PREFIX):]].append((lo, hi))
                    continue
                starts[e.correlation_id()] = lo
                if not name.startswith(("cuda", "cu")):
                    self.host.append((lo, hi, name))
            elif not e.is_user_annotation():
                device.append((lo, hi, name, e.linked_correlation_id()))
        self.work = sorted((lo, hi, name, starts.get(corr)) for lo, hi, name, corr in device)
        self.host.sort()
        win = self.spans.get("window") or [(min((w[0] for w in self.work), default=0.0),
                                            max((w[1] for w in self.work), default=0.0))]
        self.window = win[0]

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def in_range(self, lo: float, hi: float) -> List[Tuple[float, float, str, Optional[float]]]:
        """Work records that overlap [lo, hi], clipped to it."""
        i = bisect.bisect_left(self.work, (lo - 60.0,))
        out = []
        for w in self.work[i:]:
            if w[0] >= hi:
                break
            if w[1] > lo:
                out.append((max(w[0], lo), min(w[1], hi), w[2], w[3]))
        return out

    def busy_s(self, lo: Optional[float] = None, hi: Optional[float] = None) -> float:
        lo = self.window[0] if lo is None else lo
        hi = self.window[1] if hi is None else hi
        return busy((a, b) for a, b, _, _ in self.in_range(lo, hi))

    def kind_s(self, kind: str) -> float:
        """Device seconds of ``kind``'s records inside the window."""
        return sum(b - a for a, b, name, _ in self.in_range(*self.window)
                   if kind_of(name) == kind)

    def launched_in_s(self, name: str) -> float:
        """Device seconds of the records whose host op started inside one of
        the spans ``name``."""
        ranges = sorted(self.spans.get(name, []))
        if not ranges:
            return 0.0
        starts = [r[0] for r in ranges]
        total = 0.0
        for a, b, _, launch in self.work:
            if launch is None:
                continue
            i = bisect.bisect_right(starts, launch) - 1
            if i >= 0 and ranges[i][0] <= launch <= ranges[i][1]:
                total += b - a
        return total

    def breakdown(self, top: int = 10) -> Dict[str, List]:
        """The device ops that took most time in the window, by kind and
        name, and the longest idle gaps, each labelled with the host op in
        progress when it began and the record that ended it."""
        lo, hi = self.window
        work = self.in_range(lo, hi)
        by_name: Dict[str, float] = defaultdict(float)
        for a, b, name, _ in work:
            by_name[f"{kind_of(name)}:{name[:64]}"] += b - a
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps, end, prev = [], lo, "window start"
        for a, b, name, _ in work:
            if a > end:
                gaps.append((a - end, end, name, prev))
            if b > end:
                end, prev = b, name
        if hi > end:
            gaps.append((hi - end, end, "window end", prev))
        gaps.sort(key=lambda g: -g[0])
        labelled = [[f"host {self._host_at(t)[:40]}; before {nxt[:40]}; after {prv[:40]}", g]
                    for g, t, nxt, prv in gaps[:top]]
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": labelled}

    def _host_at(self, t: float) -> str:
        """The innermost host op running at time ``t`` (the latest-starting
        one that covers it)."""
        i = bisect.bisect_right(self.host, (t, float("inf"), ""))
        for lo, hi, name in reversed(self.host[max(0, i - 4000):i]):
            if hi >= t:
                return name
        return "none"


def from_profile(prof) -> Trace:
    return Trace(prof.profiler.kineto_results.events())
