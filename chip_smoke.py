#!/usr/bin/env python3
"""Build the PyTorch port's CUDA kernels and drive its serving and training
paths on one card.

    python3 chip_smoke.py

Two layouts of the model are served and trained: dense, and the JAX model's
space-to-depth layout (``s2d_level0`` and ``s2d_low_channel_decoders``: level
0 and decoder_3 in s2d). Seven kernels: K1 (InstanceNorm+LeakyReLU) and
K1bwd (its backward), K2a (2x upsample, dense), K2b (2x upsample into s2d),
K3 (the fused s2d block tail) and K4/K4f (the Winograd s2d conv, with the
unfolded and the folded U).

Phases (any failure makes the script exit non-zero without a result line):

1. Card and build: the card's name and power limit, then nvcc's register,
   shared-memory and spill report for every kernel; K3's bf16 conv kernel
   must spill nothing.
2. Each kernel against its plain PyTorch version on the card, at the shapes
   the 512² forward of a batch of 8 gives it; K1bwd at the shapes the b8
   train step gives it, in both layouts. A second bf16 call of K3 must
   repeat the first bit for bit.
3. The slice, in each layout: ``unet_6stage`` in bf16 from a seeded
   generator, saved as a reference-schema ``.pth``, reloaded through
   ``load_reference_checkpoint``, and three batches of 8 images answered by
   ``predict_arrays``. The launch counts of that run must be, per batch,
   K1/K2a/K2b/K3 = 22/5/0/0 dense and 16/3/2/3 s2d. The same requests are
   then answered with the plain versions and by the float32 model, and the
   masks are held to the bounds of phase 4.
4. The whole 512² forward (batch 8) with the kernels against the same model
   with the plain versions, in bf16 and float32, in each layout; and the
   float32 s2d forward against the float32 dense one (an exact rewrite).
5. Times with CUDA events: the b128 512² bf16 forward of each layout (then
   held to the bounds of phase 4 at b128), and each kernel, its plain
   version and the single PyTorch call that computes the same function
   (where there is one), at the b128 main-path shapes, beside the kernel's
   bound. Each kernel output timed there is first held to its plain
   version. K1's forward is also timed pass by pass (statistics, apply), and
   K1bwd at the 22 shapes of a b32 dense train step. K3's conv launch is
   also timed alone, beside its bound and cuDNN's time for the
   dense-equivalent conv (not the same function: context).
6. K4 through its differentiable entry point ``winograd_conv_s2d``, at b32
   on the eligible convs of ``unet_6stage`` (encoder_2..4 conv_1, decoder_0
   conv_0), in both U layouts: forward and, through autograd, dx, dW and db
   against the plain version and the direct conv in float32 (TF32 off), and
   in bf16 against the float32 direct conv; one launch per forward and one
   more per backward; times of the forward and of dx (the kernel alone, on
   U packed beforehand) against the bound and cuDNN's ``F.conv2d`` of the
   same shape. The bf16 kernel's nvcc report (registers, shared memory,
   spills) is printed; it must spill nothing, and with the unfolded U every
   bf16 call, forward and dx, must be faster than its plain version.
7. The train step of each layout: ``unet_6stage`` at full width, 512², bf16
   compute with float32 parameters, from the reference ``.pth`` of phase 3,
   SGD-Nesterov at the JAX defaults, seeded synthetic uint8 batches. Launch
   counts per step (K1/K2a/K2b/K3/K1bwd: 22/5/0/0/22 dense, 22/3/2/0/22 s2d,
   where training takes no fused tail; 0 with the plain versions), and the
   layouts of the cotangents K1bwd receives in one step; at b8 one step
   with the kernels against one with the plain versions (float32 and bf16,
   the same weights and dropout seed), and in float32 against one whose K1
   outputs are the kernel's values with the plain version's gradient; 10
   steps on one b8 batch must lower the loss; then the b32 step time,
   images/s and peak memory, and one b32 eval step.

Every forward and train step runs with the launch counts set to 0 just
before it: one with the kernels must read its counts after it, one with the
plain versions 0. The ``launches`` of the kernels line add up those counted
runs of the main paths (phases 3, 6 and 7).

The last three lines are the card (as nvidia-smi reports it), a JSON line
``{"kernels": [...]}`` and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from contextlib import contextmanager, nullcontext
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from unet_implementations_tpu_torch.data.synthetic import as_uint8, synthetic_batch
from unet_implementations_tpu_torch.kernels import _build
from unet_implementations_tpu_torch.kernels import instance_norm as k1
from unet_implementations_tpu_torch.kernels import s2d_region as k3
from unet_implementations_tpu_torch.kernels import upsample as k2
from unet_implementations_tpu_torch.kernels import winograd as k4
from unet_implementations_tpu_torch.models import blocks, convert
from unet_implementations_tpu_torch.models.s2d import (
    depth_to_space,
    space_to_depth,
    upsample2x_into_s2d,
)
from unet_implementations_tpu_torch.models.unet import DEFAULT_FEATURES, S2D_LAYOUT, unet_6stage
from unet_implementations_tpu_torch.ops.normalize import normalize_image
from unet_implementations_tpu_torch.ops.resize import upsample2x_nhwc
from unet_implementations_tpu_torch.recipes.common import predict_arrays
from unet_implementations_tpu_torch.training.steps import (
    make_segmentation_eval_step,
    make_segmentation_train_step,
)
from unet_implementations_tpu_torch.training.train_state import sgd_nesterov

SEED = 0
IMG = 512
# The batch of the predict path (phases 2-4) and of the timed forward (5).
SERVE_BATCH = 8
TIMED_BATCH = 128
# Published H100 SXM peaks (NVIDIA data sheet): device memory rate, the
# float32 rate outside the tensor cores, where the elementwise kernels
# compute, and the dense bf16 tensor-core rate (K3's conv).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_TENSOR_FLOPS_PER_S = 989e12
# Level l of the 6-stage model at 512²: (side, channels).
LEVELS = [(IMG >> l, c) for l, c in enumerate(DEFAULT_FEATURES)]
# K1 calls per forward at each level: 2 per encoder stage, 2 per decoder.
K1_CALLS = [4, 4, 4, 4, 4, 2]
# K2a input shapes (side, channels), one call per dense decoder.
K2_INPUTS = [(16, 512), (32, 512), (64, 256), (128, 128), (256, 64)]
# The s2d layout: K2b inputs (side, channels) of decoder_3 and decoder_4, and
# K3 calls (block, s2d side, original channels C; the input has 4C).
K2B_INPUTS = [(128, 128), (256, 64)]
K3_CALLS = [("encoder_0", 256, 32), ("decoder_3", 128, 64), ("decoder_4", 256, 32)]
LAYOUTS = {"dense": {}, "s2d": S2D_LAYOUT}
KERNELS = ("K1", "K1bwd", "K2a", "K2b", "K3", "K4", "K4f")
NO_LAUNCHES = dict.fromkeys(KERNELS, 0)
# Kernel launches of one forward with the kernels, and with the plain versions.
PER_FORWARD = {"dense": {**NO_LAUNCHES, "K1": sum(K1_CALLS), "K2a": len(K2_INPUTS)},
               "s2d": {**NO_LAUNCHES, "K1": sum(K1_CALLS) - 2 * len(K3_CALLS),
                       "K2a": len(K2_INPUTS) - 2, "K2b": len(K2B_INPUTS), "K3": len(K3_CALLS)}}
# A train step takes no fused tail: every s2d block runs its module path, and
# each of its 22 norms runs K1's backward.
PER_STEP = {"dense": {**PER_FORWARD["dense"], "K1bwd": sum(K1_CALLS)},
            "s2d": {**PER_FORWARD["s2d"], "K1": sum(K1_CALLS), "K3": 0,
                    "K1bwd": sum(K1_CALLS)}}
# The s2d norms of a train step (side, channels 4C, group 4): level 0's and
# decoder_3's.
K1_S2D_NORMS = [(IMG // 2, 4 * DEFAULT_FEATURES[0]), (IMG // 4, 4 * DEFAULT_FEATURES[1])]
# K4 (phase 6): the eligible 3x3 convs of unet_6stage at b32, (conv, dense
# side, Cin, Cout); Cin and Cout multiples of 128.
K4_BATCH = 32
K4_CONVS = [("encoder_2 conv_1", 128, 128, 128), ("encoder_3 conv_1", 64, 256, 256),
            ("encoder_4 conv_1", 32, 512, 512), ("decoder_0 conv_0", 32, 1024, 512)]
K4_MODES = {"K4": False, "K4f": True}  # kernel -> _FOLDED
# The train step (phase 7): the check batch and the timed batch.
CHECK_BATCH = 8
TRAIN_BATCH = 32
TRAIN_STEPS_DOWN = 10
TIMED_STEPS, WARMUP_STEPS = 5, 2
# Original sizes of the eight images of a request batch.
SIZES = [(375, 500), (512, 512), (240, 320), (500, 333), (64, 96), (1024, 768),
         (300, 300), (181, 257)]
# Tolerances of the kernel checks (K2 is bitwise). K1 sums in float32 in
# another order than the plain version: float32 outputs move by well under
# 1e-4 (sums of up to 2^18 terms). In bf16 that same float32 difference can
# tip the final rounding to the neighbouring bf16 value, so a bf16 output may
# differ by one bf16 ulp at its value plus the float32 tolerance (the latter
# matters only near zero, where an ulp is tiny).
K1_F32_TOL = 1e-4
K1_BF16_ULPS = 1.0
# K1bwd against the plain backward on the same inputs and statistics: dx,
# dscale and dbias within K1_F32_TOL of their largest magnitude in float32
# (sum orders, and the kernel's factored sums: it adds dpre and multiplies by
# scale once per channel, where the plain version adds dpre·scale rounded per
# element); in bf16, dx within K1_BF16_ULPS plus K1_F32_TOL (the float32
# difference may tip the rounding), dscale and dbias (float32) as in float32.
# Forward bounds (phases 3-5). The forward in float32 (TF32 off,
# deterministic cuDNN) differs between kernels and plain versions only by
# K1's sum order, so its logits agree to E2E_F32_REL_L2 and its argmax to
# E2E_F32_AGREEMENT. In bf16 each of the 22 norms may round some outputs the
# other way, and the network carries those one-ulp flips to the logits like
# any other bf16 rounding; the bf16 path with kernels is therefore held to the
# float32 plain forward no worse than the bf16 path with plain versions is,
# within E2E_BF16_SLACK (relative) on rel-L2 and E2E_BF16_AGREEMENT_SLACK on
# argmax agreement.
E2E_F32_REL_L2 = 1e-4
E2E_F32_AGREEMENT = 0.999
E2E_BF16_SLACK = 0.25
E2E_BF16_AGREEMENT_SLACK = 0.005
# K3 against its plain version. float32: 1e-4 (rtol and atol), from the sum
# orders of the statistics and of the conv. bfloat16, elementwise: the conv
# sums in another order than cuDNN, so a conv output may round one bf16 ulp
# the other way, and IN2 carries that ulp into the result scaled by
# |scale2 · rstd2| (``_torch_tail(carried_ulp=True)`` gives it per element);
# the result may then round once more the other way, and K1's apply pass
# activates before it rounds (one more): two bf16 ulps of the result plus the
# carried conv ulp plus 1e-4. IN1's statistics, summed in another order, also
# round a few conv inputs the other way; a conv output near zero can then
# move by more than its own ulp. So at most K3_BF16_OUTLIER_SHARE of the
# elements may exceed the elementwise bound, and the kernel must be as close
# to the float32 computation of the same function on the same bf16 values as
# the plain version is: max and mean |error| within E2E_BF16_SLACK of the
# plain version's.
K3_F32_TOL = 1e-4
K3_BF16_ULPS = 2.0
K3_BF16_OUTLIER_SHARE = 1e-4
# K4 in float32 (TF32 off): max |error| / max |reference| of the forward and
# of dx, dW and db, against the plain version and against the direct conv
# (the tolerance of tests/test_winograd.py: Winograd reassociates the sums).
# In bf16 the kernel transforms in float32 and rounds once where the plain
# version (as JAX) rounds after each add, so both are held to the float32
# direct conv: the kernel's rel-L2 within E2E_BF16_SLACK of the plain one's.
K4_F32_TOL = 1e-4
# And in bf16 the kernel's rel-L2 to the float32 direct conv, y and dx, at
# most this: a transform in float32 rounded once reads 4.28e-3 to 4.32e-3 at
# these shapes (PERF.md), the plain version about 5e-3.
K4_BF16_REL_L2 = 4.8e-3
# The bf16 kernels, as their mangled names show in nvcc's report.
K4_BF16_KERNEL = "winograd_s2d_wgmma_kernel"
K3_BF16_KERNEL = "s2d_conv_wgmma_kernel"
# The train step at b8 in float32 (TF32 off, deterministic cuDNN). The loss
# with the kernels against the plain versions: TRAIN_F32_LOSS_REL. Gradients
# are compared per group: each parameter alone, except that a conv followed
# by InstanceNorm goes with its bias, whose exact gradient is zero (the norm
# removes it) and whose computed gradient is rounding noise.
#
# Against the plain step, the gradients cannot meet 1e-4: K1 sums in another
# order than the plain version, a pre-activation within a float32 rounding of
# zero then takes the other slope of the LeakyReLU, and its gradient jumps.
# A plain step whose K1 sums run over the flipped input (``k1_reordered``,
# logged in every run) shows how far the order alone moves them: worst group
# 3.416e-3 dense, 5.718e-3 s2d, where the step with the kernels read 3.479e-3
# and 4.806e-3 (H100 80GB HBM3, 700 W; the same in three runs of this
# script). TRAIN_F32_PLAIN_GRAD_REL sits 2.6x above the larger reading; a
# backward that is wrong as a whole reads more, but one that is a little off
# may not. So the gradients are also gated at TRAIN_F32_GRAD_REL against a
# step whose K1 outputs and statistics are the kernel's values,
# differentiated as the plain version (autograd through its ops): the same
# forward and the same slopes, so the two differ only by the backward's
# arithmetic (K1's backward kernel against autograd of the plain ops, K2's
# transpose against autograd of the plain lerps).
#
# In bf16 the step with the kernels must be no further from the float32
# plain step than the bf16 plain step is, within E2E_BF16_SLACK.
TRAIN_F32_LOSS_REL = 1e-5
TRAIN_F32_PLAIN_GRAD_REL = 1.5e-2
TRAIN_F32_GRAD_REL = 1e-4
# Timed calls cycle through copies of their input that together hold at
# least this many times the card's L2, so no call reads its input from L2.
L2_MULTIPLE = 4

failures: list[str] = []
report: dict = {"err": dict.fromkeys(KERNELS, 0.0), "path_launches": dict.fromkeys(KERNELS, 0),
                "rows": {}, "bound_by": {}}


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str):
    def wrap(fn):
        def run(*args, **kwargs):
            log(f"== {name}")
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            except Exception:
                failures.append(name)
                log(f"!! phase failed: {name}\n{traceback.format_exc()}")
                return None
            finally:
                log(f"   ({time.perf_counter() - t0:.1f} s)")
        return run
    return wrap


def nvidia_smi_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


WRAPPERS = {"K1": k1.fused_instance_norm, "K2a": k2.upsample2x_nhwc_fast,
            "K2b": k2.upsample2x_into_s2d_fast, "K3": k3.fused_s2d_tail}


def launches() -> dict:
    counts = {name: fn.launches for name, fn in WRAPPERS.items()}
    counts["K1bwd"] = k1.fused_instance_norm.backward_launches
    counts["K4"] = k4.winograd_conv_s2d.launches
    counts["K4f"] = k4.winograd_conv_s2d.launches_folded
    return counts


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
    k1.fused_instance_norm.backward_launches = 0
    k4.winograd_conv_s2d.launches = 0
    k4.winograd_conv_s2d.launches_folded = 0


def add_path_launches() -> None:
    """Add the counts read now, just after a run of a main path that started
    with them at 0, to the kernels line's launches."""
    for name, n in launches().items():
        report["path_launches"][name] += n


def counted(fn, expected: dict):
    """``fn()`` with the launch counts set to 0 just before it; fails unless
    they read ``expected`` just after."""
    reset_launches()
    out = fn()
    if launches() != expected:
        raise AssertionError(f"expected launches {expected}, got {launches()}")
    return out


def counted_path(fn, expected: dict):
    """``counted`` for a run of a main path: its counts go into the kernels
    line."""
    out = counted(fn, expected)
    add_path_launches()
    return out


def times(expected: dict, n: int) -> dict:
    return {k: v * n for k, v in expected.items()}


def k1_plain(x, s, b, eps, slope, group=1):
    return k1._torch_forward(x, s, b, eps, slope, group)[0]


class _Values(torch.autograd.Function):
    """``values`` in the forward, the gradient of ``differentiable`` in the
    backward."""

    @staticmethod
    def forward(ctx, differentiable, values):
        return values.clone()

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def k1_kernel_values(x, s, b, eps, slope, group=1):
    """K1's output, mean and rstd (one launch), differentiated as the plain
    version: its op sequence with the kernel's statistics in value, so the
    LeakyReLU takes the slope K1's backward takes at every element."""
    with torch.no_grad():
        y_k, mean_k, rstd_k = k1._cuda_forward(x, s, b, eps, slope, group)
    _, mean, rstd = k1._torch_forward(x, s, b, eps, slope, group)
    mean, rstd = _Values.apply(mean, mean_k), _Values.apply(rstd, rstd_k)
    y = (x.to(torch.float32) - mean[:, None, None, :]) * rstd[:, None, None, :]
    y = y * s.to(torch.float32).repeat(group) + b.to(torch.float32).repeat(group)
    y = torch.where(y >= 0, y, y * slope).to(x.dtype)
    return _Values.apply(y, y_k)


def k1_reordered(x, s, b, eps, slope, group=1):
    """The plain version with its sums over the spatially flipped input: the
    same function, its float32 sums in another order."""
    return k1_plain(x.flip((1, 2)), s, b, eps, slope, group).flip((1, 2))


@contextmanager
def plain_versions(k1_version=k1_plain):
    """Route the model's blocks through the plain PyTorch versions (K1
    through ``k1_version``)."""
    names = ("fused_instance_norm", "upsample2x_nhwc_fast", "upsample2x_into_s2d_fast",
             "fused_s2d_tail")
    saved = [getattr(blocks, name) for name in names]
    plain = (k1_version, upsample2x_nhwc, upsample2x_into_s2d, k3._torch_tail)
    for name, fn in zip(names, plain):
        setattr(blocks, name, fn)
    try:
        yield
    finally:
        for name, fn in zip(names, saved):
            setattr(blocks, name, fn)


@contextmanager
def deterministic():
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = False


def bf16_ulps_map(a: torch.Tensor, b: torch.Tensor, atol=0.0) -> torch.Tensor:
    """max(|a - b| - atol, 0) in units of the bf16 spacing at max(|a|, |b|),
    per element; ``atol`` a number or a tensor like a."""
    a, b = a.float(), b.float()
    mag = torch.maximum(a.abs(), b.abs()).clamp_min(2.0 ** -126)
    excess = ((a - b).abs() - atol).clamp_min(0.0)
    return excess / torch.exp2(torch.floor(torch.log2(mag)) - 7)


def bf16_ulps(a: torch.Tensor, b: torch.Tensor, atol=0.0) -> float:
    return float(bf16_ulps_map(a, b, atol).max())


def check_k1(x, scale, bias, group: int = 1) -> str:
    """K1 against its plain version on the same inputs; fails beyond the tolerance."""
    got = counted(lambda: k1.fused_instance_norm(x, scale, bias, 1e-5, 0.01, group),
                  one_launch("K1"))
    want = k1._torch_forward(x, scale, bias, 1e-5, 0.01, group)[0]
    err = float((got.float() - want.float()).abs().max())
    report["err"]["K1"] = max(report["err"]["K1"], err)
    if x.dtype == torch.float32:
        ok = torch.allclose(got, want, rtol=K1_F32_TOL, atol=K1_F32_TOL)
        detail = f"max_abs_err {err:.3e} (tol {K1_F32_TOL:g})"
    else:
        ulps = bf16_ulps(got, want, K1_F32_TOL)
        ok = ulps <= K1_BF16_ULPS
        detail = (f"max_abs_err {err:.3e}, max {bf16_ulps(got, want):.0f} bf16 ulp; "
                  f"beyond {K1_F32_TOL:g}: {ulps:.0f} ulp (tol 1 ulp + {K1_F32_TOL:g})")
    label = f"K1 {tuple(x.shape)} {str(x.dtype)[6:]} group {group}"
    if not ok:
        raise AssertionError(f"{label} disagrees with its plain version: {detail}")
    return f"{label}: {detail} ok"


def one_launch(kernel: str) -> dict:
    return {**NO_LAUNCHES, kernel: 1}


def k1_bwd_inputs(b: int, side: int, c: int, dtype, group: int = 1, seed: int = SEED):
    """x, scale, bias, the forward's mean and rstd (from the kernel), and dy."""
    x, scale, bias = k1_inputs(b, side, c, dtype, group, seed)
    with torch.no_grad():
        _, mean, rstd = k1._cuda_forward(x, scale, bias, 1e-5, 0.01, group)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    dy = torch.randn(x.shape, generator=g, device="cuda").to(dtype)
    return x, scale, bias, mean, rstd, dy


def check_k1_bwd(args, group: int = 1) -> str:
    """K1bwd against the plain backward on the same inputs and statistics;
    fails beyond the tolerances (K1_F32_TOL of the max; K1_BF16_ULPS + K1_F32_TOL
    for bf16 dx)."""
    x = args[0]
    got = counted(lambda: k1._cuda_backward(*args, 0.01, group), one_launch("K1bwd"))
    want = k1._torch_backward(*args, 0.01, group)
    errs = {name: rel_of_max(g, w) for name, g, w in zip(("dx", "dscale", "dbias"), got, want)}
    report["err"]["K1bwd"] = max(report["err"]["K1bwd"],
                                 float((got[0].float() - want[0].float()).abs().max()))
    ok = all(errs[k] <= K1_F32_TOL for k in ("dscale", "dbias"))
    detail = ", ".join(f"{k} {v:.2e} of max" for k, v in errs.items())
    if x.dtype == torch.float32:
        ok = ok and errs["dx"] <= K1_F32_TOL
        detail += f" (tol {K1_F32_TOL:g})"
    else:
        ulps = bf16_ulps(got[0], want[0], K1_F32_TOL)
        ok = ok and ulps <= K1_BF16_ULPS
        detail += (f"; dx max {bf16_ulps(got[0], want[0]):.0f} bf16 ulp, beyond {K1_F32_TOL:g}: "
                   f"{ulps:.0f} ulp (tol 1 ulp + {K1_F32_TOL:g}; dscale, dbias {K1_F32_TOL:g})")
    label = f"K1bwd {tuple(x.shape)} {str(x.dtype)[6:]} group {group}"
    if not ok:
        raise AssertionError(f"{label} disagrees with its plain version: {detail}")
    return f"{label}: {detail} ok"


def check_k2(x, s2d: bool = False) -> str:
    """K2a (or K2b) against its plain version on the same input; fails unless
    bitwise equal."""
    kernel = "K2b" if s2d else "K2a"
    fast, plain = ((k2.upsample2x_into_s2d_fast, upsample2x_into_s2d) if s2d
                   else (k2.upsample2x_nhwc_fast, upsample2x_nhwc))
    got = counted(lambda: fast(x), one_launch(kernel))
    want = plain(x)
    err = float((got.float() - want.float()).abs().max())
    report["err"][kernel] = max(report["err"][kernel], err)
    label = f"{kernel} {tuple(x.shape)} {str(x.dtype)[6:]}"
    if not torch.equal(got, want):
        raise AssertionError(f"{label} differs from its plain version (max_abs_err {err:.3e})")
    return f"{label}: bitwise equal ({tuple(got.shape)}, {got.numel()} elements)"


def check_k3(args, label: str) -> str:
    """K3 against its plain version on the same inputs; fails beyond the
    tolerances (K3_F32_TOL; K3_BF16_ULPS, K3_BF16_OUTLIER_SHARE and the
    float32 comparison for bf16)."""
    x = args[0]
    got = counted(lambda: k3.fused_s2d_tail(*args), one_launch("K3"))
    want, carried = k3._torch_tail(*args, 1e-5, 0.01, carried_ulp=True)
    err = float((got.float() - want.float()).abs().max())
    report["err"]["K3"] = max(report["err"]["K3"], err)
    if x.dtype == torch.float32:
        ok = torch.allclose(got, want, rtol=K3_F32_TOL, atol=K3_F32_TOL)
        detail = f"max_abs_err {err:.3e} (tol {K3_F32_TOL:g})"
    else:
        ulps = bf16_ulps_map(got, want, carried + K3_F32_TOL)
        share = float((ulps > K3_BF16_ULPS).float().mean())
        ref = k3._torch_tail(x.float(), *args[1:], 1e-5, 0.01)
        e_k, e_p = (got.float() - ref).abs(), (want.float() - ref).abs()
        max_k, max_p, mean_k, mean_p = (float(e_k.max()), float(e_p.max()), float(e_k.mean()),
                                        float(e_p.mean()))
        ok = (share <= K3_BF16_OUTLIER_SHARE and max_k <= max_p * (1 + E2E_BF16_SLACK)
              and mean_k <= mean_p * (1 + E2E_BF16_SLACK))
        detail = (f"max_abs_err {err:.3e}, max {bf16_ulps(got, want):.2f} bf16 ulp; beyond 2 ulp "
                  f"+ carried conv ulp + {K3_F32_TOL:g}: {share:.2e} of elements (tol "
                  f"{K3_BF16_OUTLIER_SHARE:g}), at most {float(ulps.max()):.2f} ulp; |error| "
                  f"against float32, kernel/plain: max {max_k:.4e}/{max_p:.4e}, mean "
                  f"{mean_k:.4e}/{mean_p:.4e} (slack {E2E_BF16_SLACK:g})")
        del ref, e_k, e_p, ulps
        # No atomics anywhere in the tail: a second call repeats bit for bit.
        repeats = torch.equal(got, k3.fused_s2d_tail(*args))
        ok = ok and repeats
        detail += f"; a second call {'repeats bit for bit' if repeats else 'DIFFERS'}"
    label = f"K3 {label} {tuple(x.shape)} {str(x.dtype)[6:]}"
    if not ok:
        raise AssertionError(f"{label} disagrees with its plain version: {detail}")
    return f"{label}: {detail} ok"


def check_forwards(served, reference, x: torch.Tensor, per_forward: dict) -> dict:
    """The bf16 and float32 models with the kernels and with the plain
    versions on the same input ``x``; fails unless the bounds are met. Returns
    the rel-L2 and argmax agreement of each pair, and the float32 logits with
    the kernels."""
    with deterministic(), torch.inference_mode():
        out = {"bf16": counted(lambda: served(x), per_forward),
               "bf16 again": counted(lambda: served(x), per_forward),
               "f32": counted(lambda: reference(x), per_forward)}
        with plain_versions():
            out["bf16 plain"] = counted(lambda: served(x), NO_LAUNCHES)
            out["f32 plain"] = counted(lambda: reference(x), NO_LAUNCHES)

    pairs = [("bf16", "bf16 plain"), ("f32", "f32 plain"), ("bf16", "f32 plain"),
             ("bf16 plain", "f32 plain")]
    e2e = {f"{a} vs {b}": compare(out[a], out[b]) for a, b in pairs}
    for name, (r, a) in e2e.items():
        log(f"{name}: logits rel-L2 {r:.4e}, argmax agreement {a:.6f}")
    repeat = torch.equal(out["bf16"], out["bf16 again"])
    log(f"bf16 forward repeats bit for bit: {repeat}")
    f32_r, f32_a = e2e["f32 vs f32 plain"]
    (k_r, k_a), (p_r, p_a) = e2e["bf16 vs f32 plain"], e2e["bf16 plain vs f32 plain"]
    checks = {
        "finite": all(bool(torch.isfinite(v).all()) for v in out.values()),
        "repeat": repeat,
        "f32 rel-L2": f32_r <= E2E_F32_REL_L2,
        "f32 agreement": f32_a >= E2E_F32_AGREEMENT,
        "bf16 rel-L2 vs f32": k_r <= p_r * (1 + E2E_BF16_SLACK),
        "bf16 agreement vs f32": k_a >= p_a - E2E_BF16_AGREEMENT_SLACK,
    }
    log(f"bounds: f32 rel-L2 <= {E2E_F32_REL_L2:g}, agreement >= {E2E_F32_AGREEMENT:g}; "
        f"bf16 rel-L2 to f32 plain <= {p_r * (1 + E2E_BF16_SLACK):.4e}, agreement to f32 "
        f"plain >= {p_a - E2E_BF16_AGREEMENT_SLACK:.6f}; {checks}")
    if not all(checks.values()):
        raise AssertionError(f"the forward with kernels misses its bounds: {checks}")
    return {"pairs": e2e, "f32": out["f32"]}


def compare(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    """Logits rel-L2 of a against b, and the share of equal argmaxes."""
    return (float((a - b).norm() / b.norm()),
            float((a.argmax(-1) == b.argmax(-1)).float().mean()))


def check_layouts_agree(f32_s2d: torch.Tensor, f32_dense: torch.Tensor, label: str) -> tuple:
    """The float32 s2d forward against the float32 dense forward on the same
    weights and input: the layout is an exact rewrite, so the bounds of the
    float32 kernel checks hold."""
    r, a = compare(f32_s2d, f32_dense)
    ok = r <= E2E_F32_REL_L2 and a >= E2E_F32_AGREEMENT
    log(f"{label} f32 s2d vs f32 dense (kernels, TF32 off): logits rel-L2 {r:.4e}, argmax "
        f"agreement {a:.6f} (bounds {E2E_F32_REL_L2:g}, {E2E_F32_AGREEMENT:g}): {ok}")
    if not ok:
        raise AssertionError(f"the f32 s2d forward is not the dense one: {r:.4e}, {a:.6f}")
    return r, a


def cuda_times(fn, inputs: list, iters: int, warmup: int = 2) -> list[float]:
    """Milliseconds of each of ``iters`` back-to-back calls ``fn(input)`` on
    the card (a pair of CUDA events around each), cycling through ``inputs``."""
    for i in range(warmup):
        fn(inputs[i % len(inputs)])
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters)]
    torch.cuda.synchronize()
    for i, (start, end) in enumerate(events):
        start.record()
        fn(inputs[i % len(inputs)])
        end.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(end) for start, end in events]


def spread(ms: list[float]) -> str:
    return f"median {statistics.median(ms):.4f} ms (min {min(ms):.4f}, max {max(ms):.4f}, n {len(ms)})"


def n_copies(nbytes: int) -> int:
    """Copies of an input of ``nbytes`` that together hold L2_MULTIPLE x L2."""
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    return max(1, -(-L2_MULTIPLE * l2 // nbytes))


def k1_inputs(b: int, side: int, c: int, dtype, group: int = 1, seed: int = SEED):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn((b, side, side, c), generator=g, device="cuda") * 2 + 0.5).to(dtype)
    cg = c // group
    scale = torch.randn(cg, generator=g, device="cuda") * 0.5 + 1.0
    bias = torch.randn(cg, generator=g, device="cuda") * 0.3
    return x, scale, bias


def k2_input(b: int, side: int, c: int, seed: int = SEED, dtype=torch.bfloat16):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((b, side, side, c), generator=g, device="cuda").to(dtype)


def k3_inputs(b: int, side: int, c: int, dtype, seed: int = SEED):
    """conv_0's output (B, side, side, 4C) and the tail's parameters."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    x = (randn(b, side, side, 4 * c) * 2 + 0.5).to(dtype)
    return (x, randn(c) * 0.25 + 1.0, randn(c) * 0.1, randn(c, c, 3, 3) * (2 / (9 * c)) ** 0.5,
            randn(c) * 0.25 + 1.0, randn(c) * 0.1)


def bytes_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def k1_bound_ms(x: torch.Tensor) -> tuple[float, str]:
    n = x.numel()
    by_bytes = bytes_ms(2 * n * x.element_size())
    # x, x*x sums (3 ops) + subtract, 2 multiplies, add, select (5 ops).
    by_ops = 8 * n / F32_FLOPS_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def k1_bwd_bound_ms(x: torch.Tensor, group: int = 1) -> tuple[float, str]:
    """Bytes: x and dy read and dx written once, the float32 statistics,
    affines and parameter gradients. Operations: xhat and the pre-activation
    (4), dpre (1), the two sums (3) and dx (5) per element."""
    n, b, c = x.numel(), x.shape[0], x.shape[-1]
    by_bytes = bytes_ms(3 * n * x.element_size() + 4 * (2 * b * c + 4 * (c // group)))
    by_ops = 13 * n / F32_FLOPS_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def k2_bound_ms(x: torch.Tensor) -> tuple[float, str]:
    n = x.numel()
    by_bytes = bytes_ms(5 * n * x.element_size())
    # 2 H-lerps + 4 W-lerps of 3 ops each per input element (6 lerps of 4
    # outputs' worth, shared halo lerps not counted twice).
    by_ops = 18 * n / F32_FLOPS_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def k3_bound_ms(x: torch.Tensor) -> tuple[float, str]:
    n = x.numel()
    c = x.shape[-1] // 4
    by_bytes = bytes_ms(2 * n * x.element_size())
    # The conv's multiply-adds on the tensor cores (bf16), and the norms'
    # float32 operations on the CUDA cores: IN1 and IN2 sums (3 + 3), IN1's
    # normalize and activation (6), IN2's apply (5) per element. The two
    # units run side by side, so the slower of the two bounds.
    conv_flops = 2 * n * 9 * c
    by_ops = max(conv_flops / BF16_TENSOR_FLOPS_PER_S, 17 * n / F32_FLOPS_PER_S) * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def k3_conv_bound_ms(x: torch.Tensor) -> tuple[float, str]:
    """K3's conv launch alone: one read of x and one write of its output, or
    its multiply-adds at the bf16 tensor rate."""
    n = x.numel()
    by_bytes = bytes_ms(2 * n * x.element_size())
    by_ops = 2 * n * 9 * (x.shape[-1] // 4) / BF16_TENSOR_FLOPS_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def time_k3_conv(args) -> list[float]:
    """Times of K3's conv launch alone (``conv_only``), on IN1's statistics
    that one full launch left in the buffers; fails unless it writes what the
    full launch's conv wrote."""
    x = args[0]
    w = k3.kernel_weights(args[3], x.dtype)
    buffers = k3.tail_buffers(x)
    k3.launch_tail(x, *args[1:3], w, *args[4:], buffers, 1e-5, 0.01)
    full = buffers["y_conv"].clone()
    buffers["y_conv"].zero_()
    t = cuda_times(lambda a: k3.launch_tail(a, *args[1:3], w, *args[4:], buffers, 1e-5, 0.01,
                                            conv_only=True), [x], iters=10)
    if not torch.equal(full, buffers["y_conv"]):
        raise AssertionError("K3's conv launch alone wrote another y_conv than the full launch")
    return t


@phase("1. card and build")
def phase_build():
    report["card"] = nvidia_smi_card()
    log(f"nvidia-smi: {report['card']}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.library()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log.splitlines():
        if line.startswith("[nvcc") or "ptxas info" in line and (
                "Used" in line or "spill" in line or "Compiling entry" in line):
            log(f"   {line.strip()}")
    log(f"{K3_BF16_KERNEL} (K3's bf16 conv):")
    check_no_spills(K3_BF16_KERNEL)


@phase(f"2. kernels against their plain versions (b{SERVE_BATCH}, main-path shapes)")
def phase_kernels():
    b = SERVE_BATCH
    with torch.inference_mode():
        for side, c in LEVELS:
            for dt in (torch.bfloat16, torch.float32):
                log(check_k1(*k1_inputs(b, side, c, dt)))
        # Level 0 in the space-to-depth layout.
        log(check_k1(*k1_inputs(b, IMG // 2, 4 * DEFAULT_FEATURES[0], torch.bfloat16, 4), 4))
        # K1bwd at the b8 train step's shapes: each dense level, and the s2d norms.
        for side, c in LEVELS:
            for dt in (torch.bfloat16, torch.float32):
                log(check_k1_bwd(k1_bwd_inputs(b, side, c, dt)))
        for side, c in K1_S2D_NORMS:
            for dt in (torch.bfloat16, torch.float32):
                log(check_k1_bwd(k1_bwd_inputs(b, side, c, dt, 4), 4))
        torch.cuda.empty_cache()
        for side, c in K2_INPUTS:
            log(check_k2(k2_input(b, side, c, seed=side)))
        for side, c in K2B_INPUTS:
            for dt in (torch.bfloat16, torch.float32):
                log(check_k2(k2_input(b, side, c, seed=side, dtype=dt), s2d=True))
        with deterministic():
            for i, (block, side, c) in enumerate(K3_CALLS):
                for dt in (torch.bfloat16, torch.float32):
                    log(check_k3(k3_inputs(b, side, c, dt, seed=SEED + i), block))


def serve_layout(layout: str, path: Path, batches: list, seed_model) -> None:
    """Load the ``.pth`` in ``layout``, answer the request batches with the
    kernels (checking the launch counts), then with the plain versions and by
    the float32 model, and hold the masks to the bounds of phase 4."""
    per_forward = PER_FORWARD[layout]
    served = convert.load_reference_checkpoint(path, device="cuda", dtype=torch.bfloat16,
                                               **LAYOUTS[layout])
    for (name, a), b in zip(seed_model.state_dict().items(), served.state_dict().values()):
        if not torch.equal(a, b):
            raise AssertionError(f"reloaded weight differs: {name}")
    reference = unet_6stage(dtype=torch.float32, device="cuda", **LAYOUTS[layout])
    reference.load_state_dict(served.state_dict())
    reference.eval()
    report["models"][layout] = served, reference

    def serve(m):
        return [predict_arrays(m, images, SIZES) for images in batches]

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    results = serve(served)
    elapsed = time.perf_counter() - t0
    report["launches"][layout] = launches()
    add_path_launches()
    log(f"{layout}: 3 batches of {SERVE_BATCH} answered in {elapsed * 1e3:.1f} ms (host clock, "
        f"first calls included); launches {report['launches'][layout]}")
    for masks in results:
        for mask, size in zip(masks, SIZES):
            if mask.shape != size or mask.dtype != np.uint8:
                raise AssertionError(f"mask {mask.shape} {mask.dtype} for original size {size}")
            if not set(np.unique(mask)) <= {0, 1, 2}:
                raise AssertionError(f"mask values {np.unique(mask)} outside {{0,1,2}}")
    flat = {"bf16": np.concatenate([mask.ravel() for ms in results for mask in ms])}
    log(f"{layout}: mask class counts {np.bincount(flat['bf16'], minlength=3).tolist()}")
    if report["launches"][layout] != times(per_forward, len(batches)):
        raise AssertionError(f"expected {times(per_forward, len(batches))} launches, "
                             f"got {report['launches'][layout]}")

    # The same requests with the plain versions and by the float32 model.
    for name, m, plain in (("bf16 plain", served, True), ("f32", reference, False),
                           ("f32 plain", reference, True)):
        with deterministic(), plain_versions() if plain else nullcontext():
            masks = counted(lambda: serve(m),
                            NO_LAUNCHES if plain else times(per_forward, len(batches)))
        flat[name] = np.concatenate([mask.ravel() for ms in masks for mask in ms])

    def agree(a, b):
        return float((flat[a] == flat[b]).mean())

    f32_a, k_a, p_a = (agree("f32", "f32 plain"), agree("bf16", "f32 plain"),
                       agree("bf16 plain", "f32 plain"))
    report["mask_agreement"][layout] = {
        "f32 vs f32 plain": f32_a, "bf16 vs f32 plain": k_a, "bf16 plain vs f32 plain": p_a,
        "bf16 vs bf16 plain": agree("bf16", "bf16 plain")}
    report["masks"][layout] = flat
    for name, a in report["mask_agreement"][layout].items():
        log(f"{layout}: masks {name}: agreement {a:.6f}")
    checks = {"f32 agreement": f32_a >= E2E_F32_AGREEMENT,
              "bf16 agreement vs f32": k_a >= p_a - E2E_BF16_AGREEMENT_SLACK}
    log(f"{layout}: bounds: f32 agreement >= {E2E_F32_AGREEMENT:g}, bf16 agreement to f32 "
        f"plain >= {p_a - E2E_BF16_AGREEMENT_SLACK:.6f}; {checks}")
    if not all(checks.values()):
        raise AssertionError(f"the served masks with kernels miss their bounds: {checks}")


@phase("3. the slice: reference .pth -> load_reference_checkpoint -> predict_arrays")
def phase_slice():
    model = unet_6stage(dtype=torch.bfloat16, device="cuda",
                        generator=torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    batches = [rng.integers(0, 256, (SERVE_BATCH, IMG, IMG, 3), dtype=np.uint8)
               for _ in range(3)]
    report.update(models={}, launches={}, mask_agreement={}, masks={})
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "unet_6stage.pth"
        convert.save_reference_checkpoint(model, path)
        for layout in LAYOUTS:
            serve_layout(layout, path, batches, model)
    # One .pth, two layouts: the float32 masks of the two agree as the f32
    # masks with kernels agree with their plain versions.
    a = float((report["masks"]["s2d"]["f32"] == report["masks"]["dense"]["f32"]).mean())
    report["mask_agreement"]["f32 s2d vs f32 dense"] = a
    log(f"masks f32 s2d vs f32 dense: agreement {a:.6f} (bound {E2E_F32_AGREEMENT:g})")
    if a < E2E_F32_AGREEMENT:
        raise AssertionError(f"f32 s2d masks agree with the dense ones on only {a:.6f}")


@phase(f"4. whole forward: kernels against plain versions (b{SERVE_BATCH} 512²)")
def phase_e2e():
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    pixels = torch.randint(0, 256, (SERVE_BATCH, IMG, IMG, 3), generator=g, device="cuda",
                           dtype=torch.uint8)
    x = normalize_image(pixels)
    results = {}
    for layout in LAYOUTS:
        log(f"-- {layout}")
        results[layout] = check_forwards(*report["models"][layout], x, PER_FORWARD[layout])
    report["e2e"] = {k: v["pairs"] for k, v in results.items()}
    report["layouts_b8"] = check_layouts_agree(results["s2d"]["f32"], results["dense"]["f32"],
                                               f"b{SERVE_BATCH}")


def time_kernel(name: str, fn, plain, inputs: list, bound: tuple, library=None,
                iters: int = 10) -> list:
    """[kernel ms, plain ms, bound ms, library ms] medians of one call, logged."""
    t = cuda_times(fn, inputs, iters=iters)
    tp = cuda_times(plain, inputs, iters=3)
    tl = cuda_times(library, inputs, iters=iters) if library else None
    lib = f", library {spread(tl)}" if tl else ""
    log(f"{name} ({len(inputs)} input(s)): kernel {spread(t)}, plain {spread(tp)}{lib}, bound "
        f"{bound[0]:.4f} ms ({bound[1]}), {bound[0] / statistics.median(t):.1%} of bound")
    return [statistics.median(t), statistics.median(tp), bound[0],
            statistics.median(tl) if tl else None]


@phase(f"5. times (CUDA events, b{TIMED_BATCH} 512² bf16) and checks at b{TIMED_BATCH}")
def phase_times():
    batch = TIMED_BATCH
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    pixels = torch.randint(0, 256, (batch, IMG, IMG, 3), generator=g, device="cuda",
                           dtype=torch.uint8)
    x = normalize_image(pixels)
    xb = x.to(torch.bfloat16)
    report["forward"] = {}
    for layout in LAYOUTS:
        model = report["models"][layout][0]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            fwd = cuda_times(lambda inp: counted(lambda: model(inp), PER_FORWARD[layout]), [xb],
                             iters=5)
        peak = torch.cuda.max_memory_allocated() / 2**30
        ms = statistics.median(fwd)
        report["forward"][layout] = {"batch": batch, "ms": ms, "img_per_s": batch / ms * 1e3,
                                     "peak_gib": peak}
        log(f"{layout} forward b{batch}: {spread(fwd)}, {batch / ms * 1e3:.1f} img/s, "
            f"peak memory {peak:.2f} GiB")
    del xb
    results = {}
    for layout in LAYOUTS:
        log(f"-- {layout} at b{batch}")
        results[layout] = check_forwards(*report["models"][layout], x, PER_FORWARD[layout])
    report["e2e_b128"] = {k: v["pairs"] for k, v in results.items()}
    report["layouts_b128"] = check_layouts_agree(results["s2d"]["f32"],
                                                 results["dense"]["f32"], f"b{batch}")
    del x, pixels, results

    # ms, plain, bound, library per forward; and K1's bound split into its
    # statistics pass (one read of x) and its apply pass (a read of x and a
    # write of y). K1 and K2a per dense forward, K2b and K3 per s2d forward.
    rows = {"K1": [0.0, 0.0, 0.0, None], "K1bwd": [0.0, 0.0, 0.0, None],
            "K2a": [0.0, 0.0, 0.0, 0.0], "K2b": [0.0, 0.0, 0.0, None],
            "K3": [0.0, 0.0, 0.0, None]}
    bound_by = {}
    k1_split = [0.0, 0.0]
    k1_passes = [0.0, 0.0]  # statistics, apply: ms per forward
    with torch.inference_mode():
        for level, ((side, c), calls) in enumerate(zip(LEVELS, K1_CALLS)):
            inputs = [k1_inputs(batch, side, c, torch.bfloat16)]
            log(check_k1(*inputs[0]))
            x = inputs[0][0]
            nbytes = x.numel() * x.element_size()
            inputs += [k1_inputs(batch, side, c, torch.bfloat16, seed=SEED + i)
                       for i in range(1, n_copies(nbytes))]
            bound = k1_bound_ms(x)
            row = time_kernel(f"K1 level {level} {tuple(x.shape)} x{calls}",
                              lambda inp: k1.fused_instance_norm(*inp),
                              lambda inp: k1._torch_forward(*inp, 1e-5, 0.01, 1), inputs, bound)
            for i in range(3):
                rows["K1"][i] += calls * row[i]
            bound_by["K1"] = bound[1]
            k1_split[0] += calls * bytes_ms(nbytes)
            k1_split[1] += calls * bytes_ms(2 * nbytes)
            # Each pass alone, on buffers made once (the apply pass reads the
            # mean and rstd the statistics pass left).
            buffers = k1.forward_buffers(x)

            def one_pass(passes, buffers=buffers):
                return lambda inp: k1.launch_forward(inp[0], inp[1], inp[2], buffers, 1e-5, 0.01,
                                                     1, passes)

            one_pass(k1.STATS)(inputs[0])
            t_stats = cuda_times(one_pass(k1.STATS), inputs, iters=10)
            t_apply = cuda_times(one_pass(k1.APPLY), inputs, iters=10)
            k1_passes[0] += calls * statistics.median(t_stats)
            k1_passes[1] += calls * statistics.median(t_apply)
            log(f"   statistics pass {spread(t_stats)}, bound {bytes_ms(nbytes):.4f} ms; apply "
                f"pass {spread(t_apply)}, bound {bytes_ms(2 * nbytes):.4f} ms")
            del inputs, x, buffers
        log(f"K1 per b{batch} dense forward by pass: statistics {k1_passes[0]:.3f} ms (bound "
            f"{k1_split[0]:.3f}), apply {k1_passes[1]:.3f} ms (bound {k1_split[1]:.3f})")
        for side, c in K2_INPUTS:
            x = k2_input(batch, side, c, seed=side)
            log(check_k2(x))
            nbytes = x.numel() * x.element_size()
            inputs = [x] + [k2_input(batch, side, c, seed=side + i)
                            for i in range(1, n_copies(nbytes))]
            # The library call on the NCHW view (channels_last memory). Its
            # NHWC kernel indexes with 32-bit ints: an output of 2^31 or more
            # elements is timed as one call per half batch.
            parts = 2 if 4 * x.numel() >= 2**31 else 1
            views = [[xh.permute(0, 3, 1, 2) for xh in xi.chunk(parts)] for xi in inputs]
            bound = k2_bound_ms(x)
            row = time_kernel(f"K2a {tuple(x.shape)}", k2.upsample2x_nhwc_fast, upsample2x_nhwc,
                              inputs, bound)
            row[3] = statistics.median(cuda_times(
                lambda halves: [F.interpolate(xh, scale_factor=2, mode="bilinear",
                                              align_corners=False) for xh in halves],
                views, iters=10))
            log(f"   F.interpolate ({parts} call(s)): median {row[3]:.4f} ms")
            for i in range(4):
                rows["K2a"][i] += row[i]
            bound_by["K2a"] = bound[1]
            del x, inputs, views
        for side, c in K2B_INPUTS:
            x = k2_input(batch, side, c, seed=side)
            log(check_k2(x, s2d=True))
            nbytes = x.numel() * x.element_size()
            inputs = [x] + [k2_input(batch, side, c, seed=side + i)
                            for i in range(1, n_copies(nbytes))]
            bound = k2_bound_ms(x)
            row = time_kernel(f"K2b {tuple(x.shape)}", k2.upsample2x_into_s2d_fast,
                              upsample2x_into_s2d, inputs, bound)
            for i in range(3):
                rows["K2b"][i] += row[i]
            bound_by["K2b"] = bound[1]
            del x, inputs
        log("K2b: no single PyTorch call writes the q-major s2d layout (F.pixel_unshuffle is "
            "c-major, channel c*4 + q), so library_ms is null.")
        with deterministic():
            timed = {}
            k3_conv = {}  # per (side, c): conv alone, cuDNN's dense conv, conv bound (ms)
            for i, (block, side, c) in enumerate(K3_CALLS):
                if (side, c) in timed:  # the same shape as an earlier call
                    row = timed[(side, c)]
                    log(f"K3 {block}: same shape as an earlier call, its times count again")
                else:
                    args = k3_inputs(batch, side, c, torch.bfloat16, seed=SEED + i)
                    log(check_k3(args, block))
                    bound = k3_bound_ms(args[0])
                    row = timed[(side, c)] = time_kernel(
                        f"K3 {block} {tuple(args[0].shape)}", lambda a: k3.fused_s2d_tail(*a),
                        lambda a: k3._torch_tail(*a, 1e-5, 0.01), [args], bound, iters=5)
                    bound_by["K3"] = bound[1]
                    # Context for a later redesign: cuDNN's conv of the same
                    # work in the dense geometry (not the same function).
                    xd = torch.randn((batch, c, 2 * side, 2 * side), device="cuda",
                                     dtype=torch.bfloat16).contiguous(
                                         memory_format=torch.channels_last)
                    wd = args[3].to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
                    td = cuda_times(lambda inp: F.conv2d(inp, wd, padding=1), [xd], iters=10)
                    log(f"   context: cuDNN F.conv2d of the dense-equivalent conv_1 "
                        f"{tuple(xd.shape)} {c}->{c} 3x3 bf16 channels_last: {spread(td)}")
                    del xd, wd
                    tc = time_k3_conv(args)
                    cbound = k3_conv_bound_ms(args[0])
                    k3_conv[(side, c)] = [statistics.median(tc), statistics.median(td), cbound[0]]
                    log(f"   K3's conv launch alone: {spread(tc)}, bound {cbound[0]:.4f} ms "
                        f"({cbound[1]}), {cbound[0] / statistics.median(tc):.1%} of bound; "
                        f"cuDNN's dense-equivalent conv {statistics.median(td):.4f} ms; whole K3 "
                        f"{row[0]:.4f} ms, bound {bound[0]:.4f} ms")
                    del args
                for j in range(3):
                    rows["K3"][j] += row[j]
        log("K3: no single PyTorch call computes IN+LeakyReLU -> conv -> IN+LeakyReLU, so "
            "library_ms is null.")
        conv_sum = [sum(k3_conv[(side, c)][j] for _, side, c in K3_CALLS) for j in range(3)]
        report["k3_conv"] = conv_sum
        log(f"K3 per b{batch} s2d forward (its {len(K3_CALLS)} calls): conv launch alone "
            f"{conv_sum[0]:.3f} ms (bound {conv_sum[2]:.3f} ms), cuDNN's dense-equivalent conv "
            f"{conv_sum[1]:.3f} ms, whole K3 {rows['K3'][0]:.3f} ms (bound "
            f"{rows['K3'][2]:.3f} ms)")
        # K1bwd at the 22 shapes of a b32 dense train step, timed last: its
        # plain version's float32 temporaries (about 10 GB at b32) change
        # where the caching allocator places the inputs timed after them.
        for level, ((side, c), calls) in enumerate(zip(LEVELS, K1_CALLS)):
            seed = SEED + 20 + 10 * level
            inputs = [k1_bwd_inputs(TRAIN_BATCH, side, c, torch.bfloat16, seed=seed)]
            log(check_k1_bwd(inputs[0]))
            x = inputs[0][0]
            inputs += [k1_bwd_inputs(TRAIN_BATCH, side, c, torch.bfloat16, seed=seed + i)
                       for i in range(1, n_copies(2 * x.numel() * x.element_size()))]
            bound = k1_bwd_bound_ms(x)
            row = time_kernel(f"K1bwd level {level} {tuple(x.shape)} x{calls}",
                              lambda a: k1._cuda_backward(*a, 0.01, 1),
                              lambda a: k1._torch_backward(*a, 0.01, 1), inputs, bound)
            for i in range(3):
                rows["K1bwd"][i] += calls * row[i]
            bound_by["K1bwd"] = bound[1]
            del inputs, x
            torch.cuda.empty_cache()
        log("K1bwd: no single PyTorch call computes the InstanceNorm+LeakyReLU backward "
            "(library_ms null).")
        log(f"K1bwd per b{TRAIN_BATCH} dense train step (sum over its 22 calls of the medians): "
            f"kernel {rows['K1bwd'][0]:.3f} ms, plain {rows['K1bwd'][1]:.3f} ms, bound "
            f"{rows['K1bwd'][2]:.3f} ms")
    report["rows"].update(rows)
    report["bound_by"].update(bound_by)
    log("K1 has no single PyTorch call computing InstanceNorm+LeakyReLU (library_ms null).")
    log(f"per b{batch} forward (sum over the main-path calls of the medians; K1, K2a dense, "
        "K2b, K3 s2d): "
        + "; ".join(f"{k}: kernel {v[0]:.3f} ms, plain {v[1]:.3f} ms, bound {v[2]:.3f} ms"
                    for k, v in rows.items() if k != "K1bwd"))
    log(f"K1 bound by pass per b{batch} forward: statistics (read x) {k1_split[0]:.3f} ms, "
        f"apply (read x, write y) {k1_split[1]:.3f} ms")


def k4_inputs(side: int, cin: int, cout: int, dtype, seed: int):
    """x (b32, side/2, side/2, 4·Cin) q-major, a Kaiming-scaled float32
    (Cout, Cin, 3, 3) kernel and a float32 bias."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((K4_BATCH, side // 2, side // 2, 4 * cin), generator=g, device="cuda")
    w = torch.randn((cout, cin, 3, 3), generator=g, device="cuda") * (2 / (9 * cin)) ** 0.5
    b = torch.randn(cout, generator=g, device="cuda") * 0.1
    return x.to(dtype), w, b


def dense_nchw(x: torch.Tensor) -> torch.Tensor:
    """The dense NCHW view (channels_last memory) of a q-major s2d tensor."""
    return depth_to_space(x).permute(0, 3, 1, 2)


def direct_conv_s2d(x, w, b):
    """The reference: cuDNN's SAME 3x3 conv of the dense view, back in s2d."""
    return space_to_depth(F.conv2d(dense_nchw(x), w, b, padding=1).permute(0, 2, 3, 1))


def rel_of_max(a: torch.Tensor, ref: torch.Tensor) -> float:
    return float((a.float() - ref.float()).abs().max() / ref.float().abs().max())


def rel_l2(a: torch.Tensor, ref: torch.Tensor) -> float:
    a, ref = a.float(), ref.float()
    return float((a - ref).norm() / ref.norm())


@contextmanager
def k4_mode(kernel: str):
    saved = k4._FOLDED
    k4._FOLDED = K4_MODES[kernel]
    try:
        yield
    finally:
        k4._FOLDED = saved


def k4_u(w: torch.Tensor, kernel: str, dtype) -> torch.Tensor:
    tw = k4.transform_weights_folded if K4_MODES[kernel] else k4.transform_weights
    return tw(w).to(dtype)


def check_k4(conv: str, side: int, cin: int, cout: int, kernel: str, dtype, seed: int) -> str:
    """One forward and backward through ``winograd_conv_s2d`` (counted: one
    launch each) against the plain version and the direct conv."""
    x, w, b = k4_inputs(side, cin, cout, dtype, seed)
    gy = torch.randn((K4_BATCH, side // 2, side // 2, 4 * cout), device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(seed + 1)).to(dtype)
    xk, wk, bk = (t.clone().requires_grad_() for t in (x, w, b))
    with k4_mode(kernel):
        y = counted_path(lambda: k4.winograd_conv_s2d(xk, wk, bk), one_launch(kernel))
        counted_path(lambda: y.backward(gy), one_launch(kernel))
    # The plain version on the same U, and on the flipped kernel for dx.
    w_flip = w.flip((2, 3)).transpose(0, 1)
    y_p = k4._torch_winograd_s2d(x, k4_u(w, kernel, dtype), b)
    dx_p = k4._torch_winograd_s2d(gy, k4_u(w_flip, kernel, dtype),
                                  torch.zeros(cin, device="cuda"))
    # The float32 direct conv on the same (rounded) values, and its grads.
    xr, wr, br = (t.detach().float().clone().requires_grad_() for t in (x, w, b))
    y_r = direct_conv_s2d(xr, wr, br)
    y_r.backward(gy.float())
    label = f"{kernel} {conv} {tuple(x.shape)} {str(dtype)[6:]}"
    report["err"][kernel] = max(report["err"][kernel], float((y.float() - y_p.float()).abs().max()))
    if dtype == torch.float32:
        errs = {"y vs plain": rel_of_max(y, y_p), "y vs direct": rel_of_max(y, y_r),
                "dx vs plain": rel_of_max(xk.grad, dx_p), "dx vs direct": rel_of_max(xk.grad, xr.grad),
                "dW vs direct": rel_of_max(wk.grad, wr.grad),
                "db vs direct": rel_of_max(bk.grad, br.grad)}
        ok = all(e <= K4_F32_TOL for e in errs.values())
        detail = ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) + f" (tol {K4_F32_TOL:g} of max)"
    else:
        errs = {"y": (rel_l2(y, y_r), rel_l2(y_p, y_r)), "dx": (rel_l2(xk.grad, xr.grad),
                                                             rel_l2(dx_p, xr.grad))}
        ok = all(k_ <= p_ * (1 + E2E_BF16_SLACK) and k_ <= K4_BF16_REL_L2
                 for k_, p_ in errs.values())
        detail = ", ".join(f"{k} rel-L2 to f32 direct kernel/plain {a:.4e}/{p_:.4e}"
                           for k, (a, p_) in errs.items())
        detail += (f" (slack {E2E_BF16_SLACK:g}, at most {K4_BF16_REL_L2:g}); dW, db rel-L2 "
                   "to f32 direct "
                   f"{rel_l2(wk.grad, wr.grad):.4e}, {rel_l2(bk.grad, br.grad):.4e}")
    if not ok:
        raise AssertionError(f"{label} disagrees: {detail}")
    return f"{label}: {detail} ok"


def k4_bound_ms(n_tiles: int, cin: int, cout: int, kernel: str) -> tuple[float, str]:
    """Bytes: x (n_tiles x 4·Cin), U (16 Cin x Cout matrices unfolded, 8 of
    3·Cin x Cout folded) and y (n_tiles x 4·Cout) in bf16, the f32 bias.
    Operations: the function's 16 Winograd products per tile, 2·Cin·Cout each
    (4/9 of the direct conv), on the bf16 tensor cores, in both layouts: the
    folded kernel multiplies more (24 per tile) for the same function."""
    u_mats = 24 if K4_MODES[kernel] else 16
    nbytes = 2 * (n_tiles * 4 * cin + u_mats * cin * cout + n_tiles * 4 * cout) + 4 * cout
    by_bytes = bytes_ms(nbytes)
    by_ops = 2 * 16 * cin * cout * n_tiles / BF16_TENSOR_FLOPS_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def ptxas_report(kernel: str) -> list[str]:
    """nvcc's ``-Xptxas -v`` lines for every instantiation of ``kernel`` in
    the build this process made ([] when it loaded a cached library)."""
    lines, keep = [], False
    for line in _build.build_log.splitlines():
        if "Compiling entry function" in line:
            keep = kernel in line
        if keep and ("ptxas info" in line or "spill" in line):
            lines.append(line.strip())
    return lines


def check_no_spills(kernel: str) -> None:
    """Log nvcc's report for ``kernel`` and fail if it spills registers."""
    report_lines = ptxas_report(kernel)
    for line in report_lines:
        log(f"   {line}")
    if not report_lines:
        log(f"   no nvcc report for {kernel}: the library was loaded from an earlier build")
    spills = [line for line in report_lines
              if any(int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", line))]
    if spills:
        raise AssertionError(f"{kernel} spills registers: {spills}")


@phase(f"6. K4 winograd_conv_s2d: kernel against plain version and direct conv (b{K4_BATCH})")
def phase_k4():
    check_no_spills(K4_BF16_KERNEL)
    with deterministic():
        for i, (conv, side, cin, cout) in enumerate(K4_CONVS):
            for kernel in K4_MODES:
                for dt in (torch.float32, torch.bfloat16):
                    log(check_k4(conv, side, cin, cout, kernel, dt, seed=SEED + 10 * i))
                    torch.cuda.empty_cache()
    # Times of the kernel launch (U transformed and packed beforehand), its
    # plain version (on the unpacked U) and cuDNN's F.conv2d + bias of the
    # same shape (bf16, channels_last), for the forward and for dx (the
    # kernel on the cotangent, Cout -> Cin).
    slower = []
    for kernel in K4_MODES:
        row = [0.0, 0.0, 0.0, 0.0]
        for i, (conv, side, cin, cout) in enumerate(K4_CONVS):
            x, w, b = k4_inputs(side, cin, cout, torch.bfloat16, seed=SEED + 10 * i)
            n_tiles = x.shape[0] * x.shape[1] * x.shape[2]
            for what, ci, co, wt in (("forward", cin, cout, w),
                                     ("dx", cout, cin, w.flip((2, 3)).transpose(0, 1))):
                # dx runs on a cotangent of y's shape, into Cin channels.
                xs = x if what == "forward" else k4_inputs(side, ci, co, torch.bfloat16,
                                                           seed=SEED + 10 * i + 1)[0]
                u = k4_u(wt, kernel, torch.bfloat16)
                packed = k4.pack_weights(u)
                bias = b if what == "forward" else torch.zeros(co, device="cuda")
                nbytes = xs.numel() * xs.element_size()
                inputs = [(xs, u, packed, bias)] + [(torch.randn_like(
                    xs, dtype=torch.float32).to(torch.bfloat16), u, packed, bias)
                    for _ in range(1, n_copies(nbytes))]
                bound = k4_bound_ms(n_tiles, ci, co, kernel)
                wd = wt.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
                bd = bias.to(torch.bfloat16)
                dense = [dense_nchw(a[0]).contiguous(memory_format=torch.channels_last)
                         for a in inputs]
                t = time_kernel(f"{kernel} {what} {conv} {tuple(xs.shape)} {ci}->{co}",
                                lambda a: k4._cuda_winograd_s2d(a[0], a[2], a[3]),
                                lambda a: k4._torch_winograd_s2d(a[0], a[1], a[3]), inputs,
                                bound)
                if not K4_MODES[kernel] and t[0] >= t[1]:
                    slower.append(f"{what} {conv}: kernel {t[0]:.4f} ms, plain {t[1]:.4f} ms")
                tl = cuda_times(lambda d: F.conv2d(d, wd, bd, padding=1), dense, iters=10)
                log(f"   cuDNN F.conv2d + bias {tuple(dense[0].shape)} {ci}->{co} bf16 "
                    f"channels_last: {spread(tl)}")
                if what == "forward":
                    row = [row[0] + t[0], row[1] + t[1], row[2] + bound[0],
                           row[3] + statistics.median(tl)]
                    report["bound_by"][kernel] = bound[1]
                del inputs, dense, xs
            del x
            torch.cuda.empty_cache()
        report["rows"][kernel] = row
        log(f"{kernel} per b{K4_BATCH} set of the four convs' forwards: kernel {row[0]:.3f} ms, "
            f"plain {row[1]:.3f} ms, bound {row[2]:.3f} ms, cuDNN {row[3]:.3f} ms")
    if slower:
        raise AssertionError(f"K4 bf16 calls not faster than the plain version: {slower}")


def grad_groups(model) -> dict:
    """Parameter names by comparison group: each parameter alone, except a
    conv followed by InstanceNorm (inside a block), whose bias goes with its
    weight (the norm cancels the bias: its exact gradient is zero)."""
    groups = {}
    for name, _ in model.named_parameters():
        prefix = name.rsplit(".", 1)[0]
        if ".block." in name and isinstance(model.get_submodule(prefix), torch.nn.Conv2d):
            groups.setdefault(prefix, []).append(name)
        else:
            groups[name] = [name]
    return groups


def group_rel_l2(grads: dict, ref: dict, groups: dict) -> dict:
    return {g: rel_l2(torch.cat([grads[n].reshape(-1) for n in names]),
                      torch.cat([ref[n].reshape(-1) for n in names]))
            for g, names in groups.items()}


def train_model(layout: str, state: dict, dtype):
    model = unet_6stage(dtype=dtype, device="cuda", **LAYOUTS[layout])
    model.load_state_dict(state, strict=True)
    return model


def device_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v).to("cuda") for k, v in batch.items()}


# The step variants of the b8 check: the launches each makes, and the
# version of K1 its blocks run (None: the wrappers, with the kernels).
STEP_MODES = {"kernels": None, "plain": k1_plain, "kernel values": k1_kernel_values,
              "reordered": k1_reordered}


def one_step(layout: str, state: dict, dtype, batch: dict, mode: str):
    """One train step from ``state`` (counted): the loss and every gradient."""
    model = train_model(layout, state, dtype)
    step = make_segmentation_train_step(model, sgd_nesterov(model.parameters()))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    expected = {"kernels": PER_STEP[layout], "kernel values": {
        **NO_LAUNCHES, "K1": PER_STEP[layout]["K1"]}}.get(mode, NO_LAUNCHES)
    k1_version = STEP_MODES[mode]
    with deterministic(), plain_versions(k1_version) if k1_version else nullcontext():
        loss = (counted_path if mode == "kernels" else counted)(lambda: float(step(batch, gen)),
                                                                 expected)
    grads = {n: p.grad.detach().float().clone() for n, p in model.named_parameters()}
    return loss, grads, grad_groups(model)


def check_train_step(layout: str, state: dict, batch: dict) -> dict:
    runs = {(torch.float32, mode): one_step(layout, state, torch.float32, batch, mode)
            for mode in STEP_MODES}
    runs.update({(torch.bfloat16, mode): one_step(layout, state, torch.bfloat16, batch, mode)
                 for mode in ("kernels", "plain")})
    f32, f32_plain = runs[(torch.float32, "kernels")], runs[(torch.float32, "plain")]
    f32_values, f32_reordered = (runs[(torch.float32, "kernel values")],
                                 runs[(torch.float32, "reordered")])
    bf, bf_plain = runs[(torch.bfloat16, "kernels")], runs[(torch.bfloat16, "plain")]
    groups = f32[2]
    loss_rel = abs(f32[0] - f32_plain[0]) / abs(f32_plain[0])
    values_loss_rel = abs(f32[0] - f32_values[0]) / abs(f32_values[0])
    g32 = group_rel_l2(f32[1], f32_values[1], groups)
    worst32 = max(g32, key=g32.get)
    g_plain = group_rel_l2(f32[1], f32_plain[1], groups)
    g_reord = group_rel_l2(f32_reordered[1], f32_plain[1], groups)
    gk = group_rel_l2(bf[1], f32_plain[1], groups)
    gp = group_rel_l2(bf_plain[1], f32_plain[1], groups)
    ratio = {g: gk[g] / gp[g] for g in groups}
    worst_ratio = max(ratio, key=ratio.get)

    def all_rel(a, b):
        return rel_l2(torch.cat([v.reshape(-1) for v in a.values()]),
                      torch.cat([v.reshape(-1) for v in b.values()]))

    all_k, all_p = all_rel(bf[1], f32_plain[1]), all_rel(bf_plain[1], f32_plain[1])
    dl_k, dl_p = abs(bf[0] - f32_plain[0]), abs(bf_plain[0] - f32_plain[0])
    med = statistics.median
    log(f"{layout} b{CHECK_BATCH} step losses: f32 {f32[0]:.7f} / plain {f32_plain[0]:.7f} "
        f"(rel {loss_rel:.3e}) / kernel values {f32_values[0]:.7f} (rel {values_loss_rel:.3e}); "
        f"bf16 {bf[0]:.7f} / plain {bf_plain[0]:.7f}")
    log(f"{layout} f32 gradients vs the step with the kernel's values and the plain gradient: "
        f"worst group rel-L2 {g32[worst32]:.3e} ({worst32}), median {med(g32.values()):.3e} over "
        f"{len(groups)} groups")
    worst_plain = max(g_plain, key=g_plain.get)
    log(f"{layout} f32 gradients vs the plain step: all parameters "
        f"{all_rel(f32[1], f32_plain[1]):.3e}, worst group {g_plain[worst_plain]:.3e} "
        f"({worst_plain}), median {med(g_plain.values()):.3e}; the plain step with K1's sums "
        f"reordered vs the plain step: all parameters "
        f"{all_rel(f32_reordered[1], f32_plain[1]):.3e}, worst group "
        f"{max(g_reord.values()):.3e}, median {med(g_reord.values()):.3e}")
    log(f"{layout} bf16 gradients to f32 plain, kernels/plain: all parameters {all_k:.4e}/"
        f"{all_p:.4e}; worst group ratio {ratio[worst_ratio]:.3f} ({worst_ratio}: "
        f"{gk[worst_ratio]:.4e}/{gp[worst_ratio]:.4e}); |loss - f32 plain| {dl_k:.3e}/{dl_p:.3e}")
    checks = {"f32 loss": loss_rel <= TRAIN_F32_LOSS_REL,
              "f32 loss, kernel values": values_loss_rel <= TRAIN_F32_LOSS_REL,
              "f32 grads": g32[worst32] <= TRAIN_F32_GRAD_REL,
              "f32 grads vs plain": g_plain[worst_plain] <= TRAIN_F32_PLAIN_GRAD_REL,
              "bf16 grads": ratio[worst_ratio] <= 1 + E2E_BF16_SLACK,
              "bf16 all grads": all_k <= all_p * (1 + E2E_BF16_SLACK),
              "bf16 loss": dl_k <= dl_p * (1 + E2E_BF16_SLACK),
              "finite": all(math.isfinite(r[0]) for r in runs.values())}
    log(f"{layout} train-step bounds: f32 loss rel <= {TRAIN_F32_LOSS_REL:g}, f32 grad rel-L2 "
        f"<= {TRAIN_F32_GRAD_REL:g} (against the kernel's values with the plain gradient) and "
        f"<= {TRAIN_F32_PLAIN_GRAD_REL:g} (against the plain step), bf16 within "
        f"{E2E_BF16_SLACK:g} of the bf16 plain step: {checks}")
    if not all(checks.values()):
        raise AssertionError(f"{layout}: the train step with kernels misses its bounds: {checks}")
    return {"f32 loss rel": loss_rel, "f32 worst grad rel-L2": g32[worst32],
            "f32 vs plain worst grad rel-L2": max(g_plain.values()),
            "f32 reordered vs plain worst grad rel-L2": max(g_reord.values()),
            "bf16 worst grad ratio": ratio[worst_ratio], "bf16 all grads": (all_k, all_p),
            "bf16 loss err": (dl_k, dl_p)}


@contextmanager
def dy_layouts(seen: list):
    """Records (shape, strides, contiguous) of each cotangent K1bwd receives:
    the kernel takes dy contiguous, and copies any other."""
    launch = k1._cuda_backward

    def spy(x, scale, bias, mean, rstd, dy, *rest):
        seen.append((tuple(dy.shape), tuple(dy.stride()), dy.is_contiguous()))
        return launch(x, scale, bias, mean, rstd, dy, *rest)

    k1._cuda_backward = spy
    try:
        yield
    finally:
        k1._cuda_backward = launch


def train_layout(layout: str, path: Path) -> None:
    served = convert.load_reference_checkpoint(path, device="cuda", dtype=torch.bfloat16,
                                               **LAYOUTS[layout])
    if any(p.dtype != torch.float32 for p in served.parameters()):
        raise AssertionError("the model's parameters are not float32")
    state = {k: v.clone() for k, v in served.state_dict().items()}
    check = device_batch(as_uint8(synthetic_batch(SEED + 3, CHECK_BATCH, IMG)))
    report["train"][layout] = {"check": check_train_step(layout, state, check)}
    torch.cuda.empty_cache()

    # Ten steps on one b8 batch (bf16, kernels) must lower the loss.
    model = train_model(layout, state, torch.bfloat16)
    step = make_segmentation_train_step(model, sgd_nesterov(model.parameters()))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    losses, seen = [], []
    for i in range(TRAIN_STEPS_DOWN):
        with dy_layouts(seen) if i == 0 else nullcontext():
            losses.append(counted_path(lambda: float(step(check, gen)), PER_STEP[layout]))
    copied = [(shape, stride) for shape, stride, contiguous in seen if not contiguous]
    log(f"{layout} K1bwd cotangents of one b{CHECK_BATCH} step: {len(seen)}, "
        f"{len(seen) - len(copied)} contiguous; not contiguous (copied first): {copied}")
    log(f"{layout} {TRAIN_STEPS_DOWN} steps on one b{CHECK_BATCH} batch: losses "
        + " ".join(f"{v:.4f}" for v in losses))
    report["train"][layout]["losses"] = losses
    if not (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"{layout}: the loss did not go down: {losses}")
    del model, step, check
    torch.cuda.empty_cache()

    # The b32 step: the model loaded from the .pth, a batch already on the card.
    batch = device_batch(as_uint8(synthetic_batch(SEED + 4, TRAIN_BATCH, IMG)))
    step = make_segmentation_train_step(served, sgd_nesterov(served.parameters()))
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_times(lambda b: counted_path(lambda: step(b, gen), PER_STEP[layout]), [batch],
                    iters=TIMED_STEPS, warmup=WARMUP_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = statistics.median(ms)
    last = counted_path(lambda: float(step(batch, gen)), PER_STEP[layout])
    log(f"{layout} train step b{TRAIN_BATCH} 512² bf16: {spread(ms)}, "
        f"{TRAIN_BATCH / med * 1e3:.1f} img/s, peak memory {peak:.2f} GiB; loss after "
        f"{WARMUP_STEPS + TIMED_STEPS + 1} steps {last:.4f}")
    if not math.isfinite(last):
        raise AssertionError(f"{layout}: the b{TRAIN_BATCH} loss is not finite")
    evaluate = make_segmentation_eval_step(served)
    evaluate(batch)
    torch.cuda.synchronize()
    ev = cuda_times(lambda b: counted_path(lambda: evaluate(b), PER_FORWARD[layout]), [batch],
                    iters=1, warmup=0)
    out = counted_path(lambda: evaluate(batch), PER_FORWARD[layout])
    cm = out["confusion"]
    if float(cm.sum()) != float((batch["mask"] != 255).sum()) or not bool(
            torch.isfinite(out["loss"])):
        raise AssertionError(f"{layout}: eval step confusion {cm.tolist()} or loss {out['loss']}")
    log(f"{layout} eval step b{TRAIN_BATCH}: {ev[0]:.3f} ms, loss {float(out['loss']):.4f}, dice "
        f"{[round(float(v), 4) for v in out['dice']]}")
    report["train"][layout].update(step_ms=med, img_per_s=TRAIN_BATCH / med * 1e3, peak_gib=peak,
                                   eval_ms=ev[0])


@phase(f"7. the train step: unet_6stage 512² bf16, f32 params, SGD-Nesterov (b{CHECK_BATCH} "
       f"checks, b{TRAIN_BATCH} times)")
def phase_train():
    report["train"] = {}
    model = unet_6stage(dtype=torch.bfloat16, device="cuda",
                        generator=torch.Generator().manual_seed(SEED + 5))
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "unet_6stage_train.pth"
        convert.save_reference_checkpoint(model, path)
        del model
        for layout in LAYOUTS:
            log(f"-- {layout}")
            train_layout(layout, path)
            torch.cuda.empty_cache()


def kernels_line() -> dict:
    rows = report["rows"]
    bound_by = report["bound_by"]
    meta = [
        ("K1 fused_instance_norm (InstanceNorm+LeakyReLU fwd)",
         "unet_implementations_tpu_torch/kernels/csrc/instance_norm.cu",
         "unet_implementations_tpu/kernels/instance_norm.py:80", "K1"),
        ("K1bwd fused_instance_norm backward (InstanceNorm+LeakyReLU bwd)",
         "unet_implementations_tpu_torch/kernels/csrc/instance_norm.cu",
         "unet_implementations_tpu/kernels/instance_norm.py:186", "K1bwd"),
        ("K2a upsample2x_nhwc_fast (2x bilinear, dense fwd)",
         "unet_implementations_tpu_torch/kernels/csrc/upsample.cu",
         "unet_implementations_tpu/kernels/upsample.py:118", "K2a"),
        ("K2b upsample2x_into_s2d_fast (2x bilinear into s2d, fwd)",
         "unet_implementations_tpu_torch/kernels/csrc/upsample.cu",
         "unet_implementations_tpu/kernels/upsample.py:134", "K2b"),
        ("K3 fused_s2d_tail (s2d block tail IN-lrelu-conv3x3-IN-lrelu, fwd)",
         "unet_implementations_tpu_torch/kernels/csrc/s2d_region.cu",
         "unet_implementations_tpu/kernels/s2d_region.py:204", "K3"),
        ("K4 winograd_conv_s2d (Winograd F(2,3) s2d conv, unfolded U, fwd and dx)",
         "unet_implementations_tpu_torch/kernels/csrc/winograd.cu",
         "unet_implementations_tpu/kernels/winograd.py:365", "K4"),
        ("K4f winograd_conv_s2d (Winograd F(2,3) s2d conv, folded U, fwd and dx)",
         "unet_implementations_tpu_torch/kernels/csrc/winograd.cu",
         "unet_implementations_tpu/kernels/winograd.py:266", "K4f"),
    ]
    out = []
    for name, source, replaces, key in meta:
        ms, plain_ms, bound_ms, library_ms = rows.get(key, [None] * 4)
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            # The counted runs of the main paths (phases 3, 6 and 7).
            "launches": report["path_launches"][key],
            "max_abs_err": report["err"][key],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by.get(key, "bytes"), "library_ms": library_ms,
        })
    return {"kernels": out}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    # Float32 is compared throughout: no TF32 in convs or matmuls.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(SEED)
    t0 = time.perf_counter()
    phase_build()
    if not failures:
        phase_kernels()
        phase_slice()
        if len(report.get("models", {})) == len(LAYOUTS):
            phase_e2e()
            phase_times()
        report.pop("models", None)
        torch.cuda.empty_cache()
        phase_k4()
        phase_train()
    log(f"total {time.perf_counter() - t0:.1f} s")
    if failures:
        print(f"chip_smoke: failed phases: {failures}", file=sys.stderr)
        return 1
    print(report["card"])
    print(json.dumps(kernels_line()))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
