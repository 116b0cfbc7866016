"""Where the device time of a forward goes, by kernel, from ``torch.profiler``.

    python -m unet_implementations_tpu_torch.utils.profiling

Profiles a few forwards of ``unet_6stage`` at b128 512² bf16 on the card
(random weights from a seed) after a warm-up, and prints the device time of
each kernel, the time by kind (convolution, the port's kernels, concat,
other), and the device's busy share of the profiled window. Needs a CUDA
card.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch

from unet_implementations_tpu_torch.models.unet import unet_6stage

# The measured serving configuration.
BATCH = 128
DTYPE = torch.bfloat16

# Substrings of kernel names, in the order they are tried. K1's two passes
# (statistics with its finalize, then apply) are kinds of their own.
KINDS = (
    ("K1a instance norm statistics", ("in_stats_kernel", "in_finalize_kernel")),
    ("K1b instance norm apply", ("in_apply_kernel",)),
    ("K2 upsample", ("upsample2x_kernel",)),
    ("convolution", ("conv", "cudnn", "xmma", "gemm", "implicit", "cutlass", "wgrad", "dgrad")),
    ("concat", ("CatArray", "cat_")),
)


def kind_of(name: str) -> str:
    for kind, keys in KINDS:
        if any(k in name for k in keys):
            return kind
    return "other"


def profile_forward(batch: int, dtype: torch.dtype, iters: int = 3, seed: int = 0) -> dict:
    model = unet_6stage(dtype=dtype, device="cuda", generator=torch.Generator().manual_seed(seed))
    model.eval()
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((batch, 512, 512, 3), generator=g, device="cuda").to(dtype)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.inference_mode():
        for _ in range(2):
            model(x)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                model(x)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    per_kernel = defaultdict(float)
    for evt in prof.key_averages():
        device_us = getattr(evt, "self_device_time_total", None)
        if device_us is None:
            device_us = getattr(evt, "self_cuda_time_total", 0.0)
        if device_us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[evt.key] += device_us / 1e3 / iters
    by_kind = defaultdict(float)
    for name, ms in per_kernel.items():
        by_kind[kind_of(name)] += ms
    busy = sum(per_kernel.values())
    return {"batch": batch, "dtype": str(dtype), "wall_ms_per_forward": wall_ms / iters,
            "device_ms_per_forward": busy, "busy_share": busy / (wall_ms / iters),
            "by_kind": dict(by_kind), "per_kernel": dict(per_kernel)}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profiling needs a CUDA card")
    r = profile_forward(BATCH, DTYPE)
    print(f"device {torch.cuda.get_device_name(0)}; b{r['batch']} 512² {r['dtype']}: "
          f"{r['wall_ms_per_forward']:.3f} ms per forward (host clock, profiler on), "
          f"device busy {r['device_ms_per_forward']:.3f} ms = {r['busy_share']:.1%}")
    for kind, ms in sorted(r["by_kind"].items(), key=lambda kv: -kv[1]):
        print(f"  {kind:<30} {ms:9.3f} ms  {ms / r['device_ms_per_forward']:6.1%}")
    print("top kernels (ms per forward):")
    for name, ms in sorted(r["per_kernel"].items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {ms:9.3f}  {name[:110]}")


if __name__ == "__main__":
    main()
