"""Where the device time of a forward and of a train step goes: by kernel
and kind, and as a cost table by op, from ``torch.profiler``.

    python -m unet_implementations_tpu_torch.utils.profiling
    python -m unet_implementations_tpu_torch.cli profile [--arch A] [--train] ...

``main`` profiles a few forwards of ``unet_6stage`` at b128 512² bf16 on the
card (random weights from a seed) after a warm-up, in the dense layout and
then in the space-to-depth one, and prints for each the device time of each
kernel, the time by kind (convolution, the port's kernels, concat,
reductions, the optimizer, other), and the device's busy share
of the profiled window. Then the same for a few b32 train steps per layout
(SGD-Nesterov, seeded synthetic uint8 batches on the card), with the step
split into forward + loss, backward and optimizer by CUDA events, and the
device time of the backward split by autograd node (the engine's own
``autograd::engine::evaluate_function`` ranges: K1's backward kernel, K2's
transpose, the casts' backward, cuDNN's, ...) beside the device time of every
cast (``aten::_to_copy``, forward and backward). Needs a CUDA card.

K1's backward is a kernel (K1bwd); K2's backward is plain torch (as JAX's is
XLA), so in a train step it shows among the "other" (elementwise) kinds, and
under its autograd node.

K3 runs K1's statistics, finalize and apply kernels for its two norms, so in
the s2d layout those count under K1's kinds; only K3's conv kernel
(``s2d_conv_wgmma_kernel`` in bf16) is a kind of its own.

The cost table (``profile_table``, ``cli profile``; the counterpart of the
JAX package's HLO cost table, ``summarize``, ``format_table``,
``diff_tables``, ``format_diff``) measures where the JAX one is analytic: a
few forwards (or train steps) of one recipe's model, after WARMUPS warm-ups
(the last traced), in a marked range under ``torch.profiler`` with shapes
and FLOPs recorded. One row per outermost ATen
op or ``unet_torch`` operator (a kernel launched outside any, such as K1bwd's
inside its autograd node, goes to the row of the range that launched it),
each value per iteration: ``calls`` (every call, also one that launched no
kernel), the measured ``device_us`` of the kernels it launched, ``flops`` (torch's estimate, for convolutions and matrix
products only), ``bytes`` (an ATen op's recorded inputs; a ``unet_torch``
operator's inputs and outputs by its kernel's own formula), and JAX's roofline
keys ``t_compute_us``, ``t_memory_us``, ``t_roofline_us`` and ``bound`` at
the H100 ceilings below, with ``share`` = roofline / measured. On the CPU
(``device="cpu"``) the times are the ops' host times.
"""

from __future__ import annotations

import math
import subprocess
import time
from collections import defaultdict
from typing import Any, Dict, Iterable, List, Optional

import torch

from unet_implementations_tpu_torch import default_device
from unet_implementations_tpu_torch.data.synthetic import as_uint8, synthetic_batch
from unet_implementations_tpu_torch.kernels import _build
from unet_implementations_tpu_torch.kernels import instance_norm, s2d_region, upsample
from unet_implementations_tpu_torch.models.unet import S2D_LAYOUT, autoencoder_6stage, unet_6stage
from unet_implementations_tpu_torch.ops.losses import segmentation_loss
from unet_implementations_tpu_torch.ops.normalize import normalize_image
from unet_implementations_tpu_torch.training.steps import (
    make_reconstruction_train_step,
    make_segmentation_train_step,
)
from unet_implementations_tpu_torch.training.train_state import sgd_nesterov

# The measured serving configuration, and the train step's batch.
BATCH = 128
TRAIN_BATCH = 32
DTYPE = torch.bfloat16

LAYOUTS = {"dense": {}, "s2d": S2D_LAYOUT}

# Kernel names by kind, in the order they are tried: a name is of a kind when
# it holds every substring of one of the kind's tuples. K1's two passes
# (statistics with its finalize, then apply) are kinds of their own; K2's
# template flag tells its s2d output (K2b) from its dense one (K2a).
KINDS = (
    ("K1bwd instance norm backward", (("in_bwd_",),)),
    ("K1a instance norm statistics", (("in_stats_kernel",), ("in_finalize_kernel",))),
    ("K1b instance norm apply", (("in_apply_kernel",),)),
    ("K2b upsample into s2d", (("upsample2x_kernel", "true>"),)),
    ("K2a upsample", (("upsample2x_kernel",),)),
    ("K3 s2d tail conv", (("s2d_conv_",),)),
    ("K4 winograd s2d conv", (("winograd_s2d_",),)),
    ("convolution", tuple((k,) for k in ("conv", "cudnn", "xmma", "gemm", "implicit",
                                         "cutlass", "wgrad", "dgrad"))),
    ("concat", (("CatArray",), ("cat_",))),
    ("optimizer (SGD)", (("multi_tensor_apply",),)),
    ("reductions", (("reduce_kernel",),)),
)


def kind_of(name: str) -> str:
    for kind, alternatives in KINDS:
        if any(all(k in name for k in keys) for keys in alternatives):
            return kind
    return "other"


# The autograd engine's range around each backward node it runs.
NODE_PREFIX = "autograd::engine::evaluate_function: "
# The ops whose device time (with their children's) is reported beside the
# nodes: every dtype cast.
OPS = ("aten::_to_copy",)


def _device_total_us(evt) -> float:
    us = getattr(evt, "device_time_total", None)
    return getattr(evt, "cuda_time_total", 0.0) if us is None else us


def _by_source(prof, iters: int) -> dict:
    """Device ms per step of each backward node's range and of each of OPS,
    the kernels launched inside them included."""
    out = defaultdict(float)
    for evt in prof.key_averages():
        if evt.key.startswith(NODE_PREFIX) or evt.key in OPS:
            out[evt.key.removeprefix(NODE_PREFIX)] += _device_total_us(evt) / 1e3 / iters
    return dict(out)


def _by_kernel(prof, iters: int) -> dict:
    per_kernel = defaultdict(float)
    for evt in prof.key_averages():
        device_us = getattr(evt, "self_device_time_total", None)
        if device_us is None:
            device_us = getattr(evt, "self_cuda_time_total", 0.0)
        if device_us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[evt.key] += device_us / 1e3 / iters
    return dict(per_kernel)


def _summary(per_kernel: dict, wall_ms: float, **meta) -> dict:
    by_kind = defaultdict(float)
    for name, ms in per_kernel.items():
        by_kind[kind_of(name)] += ms
    busy = sum(per_kernel.values())
    return {**meta, "wall_ms": wall_ms, "device_ms": busy, "busy_share": busy / wall_ms,
            "by_kind": dict(by_kind), "per_kernel": per_kernel}


def _window(fn, iters: int, device: torch.device = torch.device("cuda"),
            **options) -> tuple:
    """``fn()`` twice, then ``iters`` times under the profiler (the device's
    activity too on a card); returns the profiler and the ms per iteration
    by the host clock."""
    sync = _sync(device)
    for _ in range(2):
        fn()
    sync()
    with torch.profiler.profile(activities=_activities(device), **options) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    return prof, wall_ms


def _activities(device: torch.device) -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _sync(device: torch.device):
    return (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)


def _profile(fn, iters: int) -> tuple:
    prof, wall_ms = _window(fn, iters)
    return _by_kernel(prof, iters), wall_ms, _by_source(prof, iters)


def profile_forward(batch: int, dtype: torch.dtype, layout: str = "dense", iters: int = 3,
                    seed: int = 0) -> dict:
    model = unet_6stage(dtype=dtype, device="cuda", generator=torch.Generator().manual_seed(seed),
                        **LAYOUTS[layout])
    model.eval()
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((batch, 512, 512, 3), generator=g, device="cuda").to(dtype)
    with torch.inference_mode():
        per_kernel, wall_ms, _ = _profile(lambda: model(x), iters)
    return _summary(per_kernel, wall_ms, what="forward", batch=batch, dtype=str(dtype),
                    layout=layout)


def profile_train_step(batch: int, dtype: torch.dtype, layout: str = "dense", iters: int = 3,
                       seed: int = 0) -> dict:
    """A few train steps (after two warm-up steps) under the profiler, and one
    more split into its phases by CUDA events: forward + loss, backward,
    optimizer step."""
    model = unet_6stage(dtype=dtype, device="cuda", generator=torch.Generator().manual_seed(seed),
                        **LAYOUTS[layout])
    optimizer = sgd_nesterov(model.parameters())
    step = make_segmentation_train_step(model, optimizer)
    data = {k: torch.from_numpy(v).to("cuda")
            for k, v in as_uint8(synthetic_batch(seed, batch, 512)).items()}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    per_kernel, wall_ms, by_source = _profile(lambda: step(data, gen), iters)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    model.train()
    optimizer.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    events[0].record()
    loss = segmentation_loss(model(normalize_image(data["image"]), generator=gen), data["mask"])
    events[1].record()
    loss.backward()
    events[2].record()
    optimizer.step()
    events[3].record()
    torch.cuda.synchronize()
    phases = {name: events[i].elapsed_time(events[i + 1])
              for i, name in enumerate(("forward + loss", "backward", "optimizer"))}
    return {**_summary(per_kernel, wall_ms, what="train step", batch=batch, dtype=str(dtype),
                       layout=layout), "phases_ms": phases, "by_source": by_source}


def _print(r: dict) -> None:
    print(f"device {torch.cuda.get_device_name(0)}; {r['layout']} {r['what']} b{r['batch']} 512² "
          f"{r['dtype']}: {r['wall_ms']:.3f} ms (host clock, profiler on), device busy "
          f"{r['device_ms']:.3f} ms = {r['busy_share']:.1%}")
    for name, ms in r.get("phases_ms", {}).items():
        print(f"  phase {name:<24} {ms:9.3f} ms (CUDA events, profiler off)")
    for kind, ms in sorted(r["by_kind"].items(), key=lambda kv: -kv[1]):
        print(f"  {kind:<30} {ms:9.3f} ms  {ms / r['device_ms']:6.1%}")
    if r.get("by_source"):
        print("device time by backward node, and of every cast (ms per step):")
        for name, ms in sorted(r["by_source"].items(), key=lambda kv: -kv[1]):
            if ms > 0:
                print(f"  {ms:9.3f}  {name[:100]}")
    print(f"top kernels (ms per {r['what']}):")
    for name, ms in sorted(r["per_kernel"].items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {ms:9.3f}  {name[:110]}")


# ---------------------------------------------------------------------------
# The cost table
# ---------------------------------------------------------------------------

# Published H100 SXM peaks (NVIDIA data sheet, 700 W): device memory rate,
# the float32 rate outside the tensor cores, and the dense bf16 tensor-core
# rate.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_TENSOR_FLOPS_PER_S = 989e12

PORT_PREFIX = f"{_build.OPS_NAMESPACE}::"
# The port's operators and the bytes of one call, by their kernels' own
# formulas, from the shape and item size of the first input.
PORT_OP_BYTES = {
    f"{PORT_PREFIX}in_lrelu_fwd": instance_norm.forward_bytes,
    f"{PORT_PREFIX}upsample2x": upsample.upsample_bytes,
    f"{PORT_PREFIX}upsample2x_s2d": upsample.upsample_bytes,
    f"{PORT_PREFIX}s2d_tail": s2d_region.tail_bytes,
}
# Ops whose FLOPs the table takes from torch's estimate (the convolutions and
# matrix products; torch also counts elementwise ops, which run at another
# rate).
FLOP_OPS = ("aten::conv", "aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm",
            "aten::matmul", "aten::linear")
# Item sizes of the dtype names the profiler records.
ITEMSIZE = {"float": 4, "c10::BFloat16": 2, "c10::Half": 2, "double": 8, "long int": 8,
            "int": 4, "short int": 2, "signed char": 1, "unsigned char": 1, "bool": 1}
ARCHES = ("our_unet", "clip_unet", "ae_recon", "ae_transfer")
CLIP_DIM = 512
# The autograd engine's range around each backward node.
NODE_PREFIX = "autograd::engine::evaluate_function: "
EMPTY_ROW = {"calls": 0.0, "device_us": 0.0, "flops": 0.0, "bytes": 0.0}


# The cost table's window: the range around the profiled calls, and the
# calls before it (two untraced, then one traced so that the device's tracing
# is running when the range opens: a trace that opens cold can lose its first
# kernels).
WINDOW = "profile_window"
WARMUPS = 3


def _marked_window(fn, iters: int, device: torch.device, **options) -> tuple:
    """``fn()`` WARMUPS times, the last under the profiler, then ``iters``
    times inside the range WINDOW, the device synchronized before it and at
    its end; returns the profiler and the ms per iteration of the range by
    the host clock."""
    sync = _sync(device)
    for _ in range(WARMUPS - 1):
        fn()
    sync()
    with torch.profiler.profile(activities=_activities(device), **options) as prof:
        fn()
        sync()
        with torch.profiler.record_function(WINDOW):
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            sync()
            wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    return prof, wall_ms


def _is_op(evt) -> bool:
    return evt.name.startswith(("aten::", PORT_PREFIX))


def _anchor(evt):
    """The outermost ATen op or port operator at or above ``evt``, or None."""
    top = None
    while evt is not None:
        if _is_op(evt):
            top = evt
        evt = evt.cpu_parent
    return top


def _recorded_dtypes(prof) -> Dict[int, List[str]]:
    """The recorded input dtypes of each CPU event, by its id, where the
    profiler's events do not carry them (those of torch 2.11 do not)."""
    try:
        events = prof.profiler.kineto_results.events()
    except AttributeError:
        return {}
    return {e.correlation_id(): list(e.dtypes()) for e in events
            if e.device_type() == torch.autograd.DeviceType.CPU}


def _input_bytes(shapes, dtypes, default_itemsize: int) -> int:
    """The bytes of the recorded tensor inputs; a tensor list's items, and
    inputs whose dtype was not recorded, count at ``default_itemsize``."""
    total = 0
    for i, shape in enumerate(shapes):
        dtype = dtypes[i] if i < len(dtypes) else None
        if dtype == "TensorList":
            total += sum(math.prod(s) * default_itemsize for s in shape
                         if isinstance(s, (list, tuple)))
        elif all(isinstance(d, int) for d in shape) and (dtype in ITEMSIZE or
                                                          dtype is None and shape):
            total += math.prod(shape) * ITEMSIZE.get(dtype, default_itemsize)
    return total


def _op_bytes(evt, dtypes: List[str], default_itemsize: int) -> int:
    if evt.name in PORT_OP_BYTES:
        itemsize = ITEMSIZE.get(dtypes[0] if dtypes else None, default_itemsize)
        return PORT_OP_BYTES[evt.name](evt.input_shapes[0], itemsize)
    shapes = getattr(evt, "structured_input_shapes", None) or evt.input_shapes
    return _input_bytes(shapes, dtypes, default_itemsize)


def _busy_us(intervals: List[tuple]) -> float:
    """The length of the union of (start, end) intervals."""
    busy, end = 0.0, -math.inf
    for lo, hi in sorted(intervals):
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy


def cost_rows(prof, iters: int, dtype: torch.dtype, device: torch.device) -> tuple:
    """(rows, busy_us): the cost table of the ``iters`` iterations in the
    range WINDOW (``_marked_window``; the whole profile where there is none),
    per iteration, and the device's busy time per iteration
    (``device_busy_us``; on the CPU the top-level ops' host time). The host
    events of every thread count (the autograd engine runs a backward on its
    own)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    cuda = device.type == "cuda"
    events = prof.events()
    window = [e.time_range for e in events if e.name == WINDOW]
    lo, hi = (window[0].start, window[0].end) if window else (-math.inf, math.inf)
    anchors: Dict[int, Any] = {}
    spent: Dict[int, float] = defaultdict(float)
    in_window = set()
    for evt in events:
        if evt.device_type != torch.autograd.DeviceType.CPU or \
                not lo <= evt.time_range.start <= hi:
            continue
        in_window.add(evt.id)
        # Every top-level op is a call, whether or not it launched a kernel.
        if _is_op(evt) and _anchor(evt.cpu_parent) is None:
            anchors[evt.id] = evt
            if not cuda:
                spent[evt.id] += evt.cpu_time_total
        if cuda and evt.kernels:
            anchor = _anchor(evt) or evt
            anchors[anchor.id] = anchor
            spent[anchor.id] += sum(k.duration for k in evt.kernels)
    recorded = {} if anchors and hasattr(next(iter(anchors.values())), "input_dtypes") \
        else _recorded_dtypes(prof)
    rows: Dict[str, Dict[str, float]] = {}
    for key, anchor in anchors.items():
        row = rows.setdefault(anchor.name.removeprefix(NODE_PREFIX), dict(EMPTY_ROW))
        row["calls"] += 1
        row["device_us"] += spent[key]
        # An op that did no work (a view) moves no bytes.
        if _is_op(anchor) and spent[key] > 0:
            dtypes = getattr(anchor, "input_dtypes", None) or recorded.get(anchor.id, [])
            row["bytes"] += _op_bytes(anchor, dtypes, itemsize)
            if anchor.name.startswith(FLOP_OPS):
                row["flops"] += anchor.flops or 0
    flops_per_s = (BF16_TENSOR_FLOPS_PER_S if dtype in (torch.bfloat16, torch.float16)
                   else F32_FLOPS_PER_S)
    table = []
    for name, row in rows.items():
        row = {k: v / iters for k, v in row.items()}
        t_c = row["flops"] / flops_per_s * 1e6
        t_m = row["bytes"] / HBM_BYTES_PER_S * 1e6
        t_r = max(t_c, t_m)
        table.append({
            "name": name, "port": name.startswith(PORT_PREFIX), **row,
            "t_compute_us": t_c, "t_memory_us": t_m, "t_roofline_us": t_r,
            "bound": ("compute" if t_c >= t_m else "memory") if t_r > 0 else "-",
            "share": t_r / row["device_us"] if row["device_us"] > 0 and t_r > 0 else None,
        })
    table.sort(key=lambda r: -r["device_us"])
    if not cuda:
        return table, sum(spent.values()) / iters
    return table, device_busy_us(prof.profiler.kineto_results.events(), in_window) / iters


def _is_work(record) -> bool:
    """A device record of work (a kernel, a copy, a fill), not the span of a
    host range that the profiler also draws on the device's timeline."""
    annotation = getattr(record, "is_user_annotation", None)
    return (record.device_type() != torch.autograd.DeviceType.CPU
            and not (annotation is not None and annotation()))


def device_busy_us(records, launched_by: set) -> float:
    """The union of the intervals of the device's work records (the
    profiler's raw events) from the start of the first to the end of the last
    that a host event of ``launched_by`` (correlation ids) launched, on the
    device's own clock."""
    device = [r for r in records if _is_work(r)]
    ours = [r for r in device if r.linked_correlation_id() in launched_by]
    if not ours:
        return 0.0
    first = min(r.start_ns() for r in ours)
    last = max(r.end_ns() for r in ours)
    return _busy_us([(r.start_ns() / 1e3, r.end_ns() / 1e3) for r in device
                     if first <= r.start_ns() and r.end_ns() <= last])


def _workload(arch: str, batch_size: int, size: int, train: bool, dtype: torch.dtype,
              device: torch.device, seed: int):
    """The call the table profiles: ``arch``'s model (``ae_transfer``: the
    segmentation UNet, as JAX's profile builds it) in eval mode on a seeded
    random batch, or its train step (SGD-Nesterov, as JAX's) on a seeded
    synthetic uint8 batch."""
    if arch not in ARCHES:
        raise ValueError(f"--arch must be one of {ARCHES}, got {arch!r}")
    generator = torch.Generator().manual_seed(seed)
    clip = arch == "clip_unet"
    if arch == "ae_recon":
        model = autoencoder_6stage(dtype=dtype, device=device, generator=generator)
    else:
        model = unet_6stage(dtype=dtype, device=device, generator=generator, clip_fusion=clip)
    g = torch.Generator(device=device).manual_seed(seed)
    features = (torch.randn((batch_size, CLIP_DIM), generator=g, device=device)
                if clip else None)
    if train:
        data = as_uint8(synthetic_batch(seed, batch_size, size))
        image = torch.from_numpy(data["image"]).to(device)
        optimizer = sgd_nesterov(model.parameters())
        if arch == "ae_recon":
            batch = {"image": image, "target": image}
            step = make_reconstruction_train_step(model, optimizer)
        else:
            batch = {"image": image, "mask": torch.from_numpy(data["mask"]).to(device)}
            if clip:
                batch["clip_features"] = features
            step = make_segmentation_train_step(model, optimizer, use_clip=clip)
        return lambda: step(batch, g)
    model.eval()
    x = torch.randn((batch_size, size, size, 3), generator=g, device=device).to(dtype)

    @torch.inference_mode()
    def forward():
        return model(x, features)

    return forward


def card_description(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or what the
    times of a CPU run are."""
    if device.type != "cuda":
        return "the CPU (host times, not a device's)"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
             f"--id={device.index or 0}"], capture_output=True, text=True, timeout=60,
            check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(device)} (power limit not read)"


def profile_table(arch: str = "our_unet", batch_size: int = 128, size: int = 512,
                  train: bool = False, dtype: torch.dtype = torch.bfloat16, device=None,
                  iters: int = 3, seed: int = 0) -> Dict[str, Any]:
    """The cost table of ``arch``'s forward (or, with ``train``, its train
    step) at ``batch_size`` × ``size``², on ``device`` (CUDA unless named):
    ``{"rows", "what", "device", "iters", "busy_us", "wall_us"}``, where
    ``busy_us`` is the device's busy time per iteration and ``wall_us`` the
    host clock's per iteration, profiler on."""
    device = default_device(device)
    fn = _workload(arch, batch_size, size, train, dtype, device, seed)
    prof, wall_ms = _marked_window(fn, iters, device, record_shapes=True, with_flops=True)
    rows, busy_us = cost_rows(prof, iters, dtype, device)
    what = (f"{arch} {'train step' if train else 'forward'} b{batch_size} {size}² "
            f"{str(dtype).removeprefix('torch.')}")
    return {"rows": rows, "what": what, "device": card_description(device), "iters": iters,
            "busy_us": busy_us, "wall_us": wall_ms * 1e3}


def summarize(rows: Iterable[Dict[str, Any]]) -> Dict[str, float]:
    rows = list(rows)
    return {
        "n_ops": len(rows),
        "calls": sum(r["calls"] for r in rows),
        "device_ms": sum(r["device_us"] for r in rows) / 1e3,
        "flops": sum(r["flops"] for r in rows),
        "bytes": sum(r["bytes"] for r in rows),
        "t_roofline_ms": sum(r["t_roofline_us"] for r in rows) / 1e3,
        "t_compute_ms": sum(r["t_compute_us"] for r in rows) / 1e3,
        "t_memory_ms": sum(r["t_memory_us"] for r in rows) / 1e3,
    }


def format_table(rows: List[Dict[str, Any]], top: int = 25,
                 meta: Optional[Dict[str, Any]] = None) -> str:
    """The ``top`` rows by measured time, a total, and with ``meta`` (what
    ``profile_table`` returns) what was profiled where."""
    rows = sorted(rows, key=lambda r: -r["device_us"])
    s = summarize(rows)
    lines = [f"{'device_us':>11} {'roofline_us':>11} {'share':>6} {'bound':>7} "
             f"{'GFLOP':>9} {'MB':>9} {'calls':>6}  op"]
    for r in rows[:top]:
        share = f"{r['share']:.0%}" if r["share"] is not None else "-"
        lines.append(
            f"{r['device_us']:>11.1f} {r['t_roofline_us']:>11.1f} {share:>6} {r['bound']:>7} "
            f"{r['flops'] / 1e9:>9.2f} {r['bytes'] / 1e6:>9.2f} {r['calls']:>6g}  "
            f"{r['name'][:90]}")
    lines.append(
        f"TOTAL {s['n_ops']} ops, {s['calls']:g} calls: measured {s['device_ms']:.3f} ms, "
        f"{s['flops'] / 1e12:.3f} TFLOP, {s['bytes'] / 1e9:.3f} GB, roofline "
        f"{s['t_roofline_ms']:.3f} ms (compute {s['t_compute_ms']:.3f} / memory "
        f"{s['t_memory_ms']:.3f})")
    if meta is not None:
        lines.append(
            f"{meta['what']} on {meta['device']}, per iteration over {meta['iters']} after "
            f"{WARMUPS} warm-ups: busy {meta['busy_us'] / 1e3:.3f} ms, host clock "
            f"{meta['wall_us'] / 1e3:.3f} ms (profiler on)")
    lines.append(
        "ATen rows count their recorded inputs' bytes only, unet_torch rows their inputs and "
        "outputs; FLOPs are torch's, for convolutions and matrix products; ceilings of an "
        "H100 SXM: 989 TFLOP/s bf16 tensor, 67 TFLOP/s f32, 3.35 TB/s")
    return "\n".join(lines)


def diff_tables(rows_a: List[Dict[str, Any]],
                rows_b: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Compare two cost tables by op name: the measured time of each (b
    minus a), biggest absolute difference first."""
    ga = {r["name"]: r for r in rows_a}
    gb = {r["name"]: r for r in rows_b}
    out = []
    for name in sorted(set(ga) | set(gb)):
        a, b = ga.get(name, EMPTY_ROW), gb.get(name, EMPTY_ROW)
        out.append({
            "name": name, "a_us": a["device_us"], "b_us": b["device_us"],
            "delta_us": b["device_us"] - a["device_us"],
            "a_bytes": a["bytes"], "b_bytes": b["bytes"], "a_n": a["calls"], "b_n": b["calls"],
        })
    out.sort(key=lambda r: -abs(r["delta_us"]))
    return out


def format_diff(diff: List[Dict[str, Any]], top: int = 20) -> str:
    lines = [f"{'a_us':>10} {'b_us':>10} {'delta':>10} {'a_MB':>8} {'b_MB':>8}  op"]
    for r in diff[:top]:
        lines.append(
            f"{r['a_us']:>10.1f} {r['b_us']:>10.1f} {r['delta_us']:>+10.1f} "
            f"{r['a_bytes'] / 1e6:>8.1f} {r['b_bytes'] / 1e6:>8.1f}  {r['name'][:80]}")
    ta = sum(r["a_us"] for r in diff)
    tb = sum(r["b_us"] for r in diff)
    lines.append(f"TOTAL measured: a={ta / 1e3:.3f} ms  b={tb / 1e3:.3f} ms  "
                 f"delta={(tb - ta) / 1e3:+.3f} ms")
    return "\n".join(lines)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profiling needs a CUDA card")
    for profile, batch in ((profile_forward, BATCH), (profile_train_step, TRAIN_BATCH)):
        for layout in LAYOUTS:
            _print(profile(batch, DTYPE, layout))
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
