"""Where the device time of a forward and of a train step goes, by kernel,
from ``torch.profiler``.

    python -m unet_implementations_tpu_torch.utils.profiling

Profiles a few forwards of ``unet_6stage`` at b128 512² bf16 on the card
(random weights from a seed) after a warm-up, in the dense layout and then
in the space-to-depth one, and prints for each the device time of each
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
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch

from unet_implementations_tpu_torch.data.synthetic import as_uint8, synthetic_batch
from unet_implementations_tpu_torch.models.unet import S2D_LAYOUT, unet_6stage
from unet_implementations_tpu_torch.ops.losses import segmentation_loss
from unet_implementations_tpu_torch.ops.normalize import normalize_image
from unet_implementations_tpu_torch.training.steps import make_segmentation_train_step
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


def _profile(fn, iters: int) -> tuple:
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profiling needs a CUDA card")
    for profile, batch in ((profile_forward, BATCH), (profile_train_step, TRAIN_BATCH)):
        for layout in LAYOUTS:
            _print(profile(batch, DTYPE, layout))
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
