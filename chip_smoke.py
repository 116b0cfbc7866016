#!/usr/bin/env python3
"""Build the PyTorch port's CUDA kernels and drive its serving path on one card.

    python3 chip_smoke.py

Phases (any failure makes the script exit non-zero without a result line):

1. Card and build: the card's name and power limit, then nvcc's register,
   shared-memory and spill report for every kernel.
2. Each kernel against its plain PyTorch version on the card, at the shapes
   the 512² forward of a batch of 8 gives it.
3. The slice: ``unet_6stage`` in bf16 from a seeded generator, saved as a
   reference-schema ``.pth``, reloaded through ``load_reference_checkpoint``,
   and three batches of 8 images answered by ``predict_arrays``. The launch
   counts of that run must be 22 (K1) and 5 (K2) per batch. The same requests
   are then answered with the plain versions and by the float32 model, and
   the masks are held to the bounds of phase 4.
4. The whole 512² forward (batch 8) with the kernels against the same model
   with the plain versions, in bf16 and float32.
5. Times with CUDA events: the b128 512² bf16 forward (then held to the
   bounds of phase 4 at b128), and each kernel, its plain version and the
   single PyTorch call that computes the same function (where there is one),
   at the b128 main-path shapes, beside the kernel's bound. Each kernel
   output timed there is first held to its plain version.

Every forward runs with the launch counts set to 0 just before it: a forward
with the kernels must read 22 and 5 after it, one with the plain versions 0.

The last three lines are the card (as nvidia-smi reports it), a JSON line
``{"kernels": [...]}`` and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
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

from unet_implementations_tpu_torch.kernels import _build
from unet_implementations_tpu_torch.kernels import instance_norm as k1
from unet_implementations_tpu_torch.kernels import upsample as k2
from unet_implementations_tpu_torch.models import blocks, convert
from unet_implementations_tpu_torch.models.unet import DEFAULT_FEATURES, unet_6stage
from unet_implementations_tpu_torch.ops.normalize import normalize_image
from unet_implementations_tpu_torch.ops.resize import upsample2x_nhwc
from unet_implementations_tpu_torch.recipes.common import predict_arrays

SEED = 0
IMG = 512
# The batch of the predict path (phases 2-4) and of the timed forward (5).
SERVE_BATCH = 8
TIMED_BATCH = 128
# Published H100 SXM peaks (NVIDIA data sheet): device memory rate, and the
# float32 rate outside the tensor cores, where these kernels compute.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# Level l of the 6-stage model at 512²: (side, channels).
LEVELS = [(IMG >> l, c) for l, c in enumerate(DEFAULT_FEATURES)]
# K1 calls per forward at each level: 2 per encoder stage, 2 per decoder.
K1_CALLS = [4, 4, 4, 4, 4, 2]
# K2 input shapes (side, channels), one call per decoder.
K2_INPUTS = [(16, 512), (32, 512), (64, 256), (128, 128), (256, 64)]
# Kernel launches of one forward with the kernels, and with the plain versions.
PER_FORWARD = {"K1": sum(K1_CALLS), "K2": len(K2_INPUTS)}
NO_LAUNCHES = {"K1": 0, "K2": 0}
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
# Timed calls cycle through copies of their input that together hold at
# least this many times the card's L2, so no call reads its input from L2.
L2_MULTIPLE = 4

failures: list[str] = []
report: dict = {"k1_err": 0.0, "k2_err": 0.0}


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


def launches() -> dict:
    return {"K1": k1.fused_instance_norm.launches, "K2": k2.upsample2x_nhwc_fast.launches}


def counted(fn, expected: dict):
    """``fn()`` with the launch counts set to 0 just before it; fails unless
    they read ``expected`` just after."""
    k1.fused_instance_norm.launches = 0
    k2.upsample2x_nhwc_fast.launches = 0
    out = fn()
    if launches() != expected:
        raise AssertionError(f"expected launches {expected}, got {launches()}")
    return out


def times(expected: dict, n: int) -> dict:
    return {k: v * n for k, v in expected.items()}


@contextmanager
def plain_versions():
    """Route the model's blocks through the plain PyTorch versions."""
    saved = blocks.fused_instance_norm, blocks.upsample2x_nhwc_fast
    blocks.fused_instance_norm = lambda x, s, b, eps, slope: k1._torch_forward(
        x, s, b, eps, slope, 1)[0]
    blocks.upsample2x_nhwc_fast = upsample2x_nhwc
    try:
        yield
    finally:
        blocks.fused_instance_norm, blocks.upsample2x_nhwc_fast = saved


@contextmanager
def deterministic():
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = False


def bf16_ulps(a: torch.Tensor, b: torch.Tensor, atol: float = 0.0) -> float:
    """max(|a - b| - atol, 0) in units of the bf16 spacing at max(|a|, |b|)."""
    a, b = a.float(), b.float()
    mag = torch.maximum(a.abs(), b.abs()).clamp_min(2.0 ** -126)
    excess = ((a - b).abs() - atol).clamp_min(0.0)
    return float((excess / torch.exp2(torch.floor(torch.log2(mag)) - 7)).max())


def check_k1(x, scale, bias, group: int = 1) -> str:
    """K1 against its plain version on the same inputs; fails beyond the tolerance."""
    got = counted(lambda: k1.fused_instance_norm(x, scale, bias, 1e-5, 0.01, group),
                  {"K1": 1, "K2": 0})
    want = k1._torch_forward(x, scale, bias, 1e-5, 0.01, group)[0]
    err = float((got.float() - want.float()).abs().max())
    report["k1_err"] = max(report["k1_err"], err)
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


def check_k2(x) -> str:
    """K2 against its plain version on the same input; fails unless bitwise equal."""
    got = counted(lambda: k2.upsample2x_nhwc_fast(x), {"K1": 0, "K2": 1})
    want = upsample2x_nhwc(x)
    err = float((got.float() - want.float()).abs().max())
    report["k2_err"] = max(report["k2_err"], err)
    label = f"K2 {tuple(x.shape)} {str(x.dtype)[6:]}"
    if not torch.equal(got, want):
        raise AssertionError(f"{label} differs from its plain version (max_abs_err {err:.3e})")
    return f"{label}: bitwise equal ({tuple(got.shape)}, {got.numel()} elements)"


def check_forwards(served, reference, x: torch.Tensor) -> dict:
    """The bf16 and float32 models with the kernels and with the plain
    versions on the same input ``x``; fails unless the bounds are met."""
    with deterministic(), torch.inference_mode():
        out = {"bf16": counted(lambda: served(x), PER_FORWARD),
               "bf16 again": counted(lambda: served(x), PER_FORWARD),
               "f32": counted(lambda: reference(x), PER_FORWARD)}
        with plain_versions():
            out["bf16 plain"] = counted(lambda: served(x), NO_LAUNCHES)
            out["f32 plain"] = counted(lambda: reference(x), NO_LAUNCHES)

    def rel_l2(a, b):
        return float((out[a] - out[b]).norm() / out[b].norm())

    def agree(a, b):
        return float((out[a].argmax(-1) == out[b].argmax(-1)).float().mean())

    pairs = [("bf16", "bf16 plain"), ("f32", "f32 plain"), ("bf16", "f32 plain"),
             ("bf16 plain", "f32 plain")]
    e2e = {f"{a} vs {b}": (rel_l2(a, b), agree(a, b)) for a, b in pairs}
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
    return e2e


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


def k2_input(b: int, side: int, c: int, seed: int = SEED):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((b, side, side, c), generator=g, device="cuda").to(torch.bfloat16)


def bytes_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def k1_bound_ms(x: torch.Tensor) -> tuple[float, str]:
    n = x.numel()
    by_bytes = bytes_ms(2 * n * x.element_size())
    # x, x*x sums (3 ops) + subtract, 2 multiplies, add, select (5 ops).
    by_ops = 8 * n / F32_FLOPS_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def k2_bound_ms(x: torch.Tensor) -> tuple[float, str]:
    n = x.numel()
    by_bytes = bytes_ms(5 * n * x.element_size())
    # 2 H-lerps + 4 W-lerps of 3 ops each per input element (6 lerps of 4
    # outputs' worth, shared halo lerps not counted twice).
    by_ops = 18 * n / F32_FLOPS_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


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


@phase(f"2. kernels against their plain versions (b{SERVE_BATCH}, main-path shapes)")
def phase_kernels():
    b = SERVE_BATCH
    with torch.inference_mode():
        for side, c in LEVELS:
            for dt in (torch.bfloat16, torch.float32):
                log(check_k1(*k1_inputs(b, side, c, dt)))
        # Level 0 in the space-to-depth layout.
        log(check_k1(*k1_inputs(b, IMG // 2, 4 * DEFAULT_FEATURES[0], torch.bfloat16, 4), 4))
        for side, c in K2_INPUTS:
            log(check_k2(k2_input(b, side, c, seed=side)))


@phase("3. the slice: reference .pth -> load_reference_checkpoint -> predict_arrays")
def phase_slice():
    model = unet_6stage(dtype=torch.bfloat16, device="cuda",
                        generator=torch.Generator().manual_seed(SEED))
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "unet_6stage.pth"
        convert.save_reference_checkpoint(model, path)
        served = convert.load_reference_checkpoint(path, device="cuda", dtype=torch.bfloat16)
    for (name, a), b in zip(model.state_dict().items(), served.state_dict().values()):
        if not torch.equal(a, b):
            raise AssertionError(f"reloaded weight differs: {name}")
    reference = unet_6stage(dtype=torch.float32, device="cuda")
    reference.load_state_dict(served.state_dict())
    reference.eval()
    report["model"], report["reference"] = served, reference
    rng = np.random.default_rng(SEED)
    batches = [rng.integers(0, 256, (SERVE_BATCH, IMG, IMG, 3), dtype=np.uint8)
               for _ in range(3)]

    def serve(m):
        return [predict_arrays(m, images, SIZES) for images in batches]

    torch.cuda.synchronize()
    k1.fused_instance_norm.launches = 0
    k2.upsample2x_nhwc_fast.launches = 0
    t0 = time.perf_counter()
    results = serve(served)
    elapsed = time.perf_counter() - t0
    report["launches"] = launches()
    log(f"3 batches of {SERVE_BATCH} answered in {elapsed * 1e3:.1f} ms (host clock, first "
        f"calls included); launches {report['launches']}")
    for masks in results:
        for mask, size in zip(masks, SIZES):
            if mask.shape != size or mask.dtype != np.uint8:
                raise AssertionError(f"mask {mask.shape} {mask.dtype} for original size {size}")
            if not set(np.unique(mask)) <= {0, 1, 2}:
                raise AssertionError(f"mask values {np.unique(mask)} outside {{0,1,2}}")
    flat = {"bf16": np.concatenate([mask.ravel() for ms in results for mask in ms])}
    log(f"mask class counts {np.bincount(flat['bf16'], minlength=3).tolist()}")
    if report["launches"] != times(PER_FORWARD, len(batches)):
        raise AssertionError(f"expected {times(PER_FORWARD, len(batches))} launches, "
                             f"got {report['launches']}")

    # The same requests with the plain versions and by the float32 model.
    for name, m, plain in (("bf16 plain", served, True), ("f32", reference, False),
                           ("f32 plain", reference, True)):
        with deterministic(), plain_versions() if plain else nullcontext():
            masks = counted(lambda: serve(m),
                            NO_LAUNCHES if plain else times(PER_FORWARD, len(batches)))
        flat[name] = np.concatenate([mask.ravel() for ms in masks for mask in ms])

    def agree(a, b):
        return float((flat[a] == flat[b]).mean())

    f32_a, k_a, p_a = (agree("f32", "f32 plain"), agree("bf16", "f32 plain"),
                       agree("bf16 plain", "f32 plain"))
    report["mask_agreement"] = {"f32 vs f32 plain": f32_a, "bf16 vs f32 plain": k_a,
                                "bf16 plain vs f32 plain": p_a,
                                "bf16 vs bf16 plain": agree("bf16", "bf16 plain")}
    for name, a in report["mask_agreement"].items():
        log(f"masks {name}: agreement {a:.6f}")
    checks = {"f32 agreement": f32_a >= E2E_F32_AGREEMENT,
              "bf16 agreement vs f32": k_a >= p_a - E2E_BF16_AGREEMENT_SLACK}
    log(f"bounds: f32 agreement >= {E2E_F32_AGREEMENT:g}, bf16 agreement to f32 plain >= "
        f"{p_a - E2E_BF16_AGREEMENT_SLACK:.6f}; {checks}")
    if not all(checks.values()):
        raise AssertionError(f"the served masks with kernels miss their bounds: {checks}")


@phase(f"4. whole forward: kernels against plain versions (b{SERVE_BATCH} 512²)")
def phase_e2e():
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    pixels = torch.randint(0, 256, (SERVE_BATCH, IMG, IMG, 3), generator=g, device="cuda",
                           dtype=torch.uint8)
    report["e2e"] = check_forwards(report["model"], report["reference"], normalize_image(pixels))


@phase(f"5. times (CUDA events, b{TIMED_BATCH} 512² bf16) and checks at b{TIMED_BATCH}")
def phase_times():
    model, batch = report["model"], TIMED_BATCH
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    pixels = torch.randint(0, 256, (batch, IMG, IMG, 3), generator=g, device="cuda",
                           dtype=torch.uint8)
    x = normalize_image(pixels)
    xb = x.to(torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        fwd = cuda_times(lambda inp: counted(lambda: model(inp), PER_FORWARD), [xb], iters=5)
    peak = torch.cuda.max_memory_allocated() / 2**30
    ms = statistics.median(fwd)
    report["forward"] = {"batch": batch, "ms": ms, "img_per_s": batch / ms * 1e3,
                         "peak_gib": peak}
    log(f"forward b{batch}: {spread(fwd)}, {batch / ms * 1e3:.1f} img/s, "
        f"peak memory {peak:.2f} GiB")
    del xb
    report["e2e_b128"] = check_forwards(model, report["reference"], x)
    del x, pixels

    # ms, plain, bound, library; and K1's bound split into its statistics
    # pass (one read of x) and its apply pass (a read of x and a write of y).
    rows = {"K1": [0.0, 0.0, 0.0, None], "K2": [0.0, 0.0, 0.0, 0.0]}
    k1_split = [0.0, 0.0]
    with torch.inference_mode():
        for level, ((side, c), calls) in enumerate(zip(LEVELS, K1_CALLS)):
            inputs = [k1_inputs(batch, side, c, torch.bfloat16)]
            log(check_k1(*inputs[0]))
            x = inputs[0][0]
            nbytes = x.numel() * x.element_size()
            inputs += [k1_inputs(batch, side, c, torch.bfloat16, seed=SEED + i)
                       for i in range(1, n_copies(nbytes))]
            t = cuda_times(lambda inp: k1.fused_instance_norm(*inp), inputs, iters=10)
            tp = cuda_times(lambda inp: k1._torch_forward(*inp, 1e-5, 0.01, 1), inputs, iters=3)
            bound, k1_by = k1_bound_ms(x)
            for i, v in enumerate((statistics.median(t), statistics.median(tp), bound)):
                rows["K1"][i] += calls * v
            k1_split[0] += calls * bytes_ms(nbytes)
            k1_split[1] += calls * bytes_ms(2 * nbytes)
            log(f"K1 level {level} {tuple(x.shape)} x{calls} ({len(inputs)} input(s)): kernel "
                f"{spread(t)}, plain {spread(tp)}, bound {bound:.4f} ms ({k1_by}), "
                f"{bound / statistics.median(t):.1%} of bound")
            del inputs, x
        for side, c in K2_INPUTS:
            x = k2_input(batch, side, c, seed=side)
            log(check_k2(x))
            nbytes = x.numel() * x.element_size()
            inputs = [x] + [k2_input(batch, side, c, seed=side + i)
                            for i in range(1, n_copies(nbytes))]
            t = cuda_times(k2.upsample2x_nhwc_fast, inputs, iters=10)
            tp = cuda_times(upsample2x_nhwc, inputs, iters=3)
            # The library call on the NCHW view (channels_last memory). Its
            # NHWC kernel indexes with 32-bit ints: an output of 2^31 or more
            # elements is timed as one call per half batch.
            parts = 2 if 4 * x.numel() >= 2**31 else 1
            views = [[xh.permute(0, 3, 1, 2) for xh in xi.chunk(parts)] for xi in inputs]
            tl = cuda_times(lambda halves: [F.interpolate(xh, scale_factor=2, mode="bilinear",
                                                          align_corners=False)
                                            for xh in halves], views, iters=10)
            bound, k2_by = k2_bound_ms(x)
            for i, v in enumerate((statistics.median(t), statistics.median(tp), bound,
                                   statistics.median(tl))):
                rows["K2"][i] += v
            log(f"K2 {tuple(x.shape)} ({len(inputs)} input(s)): kernel {spread(t)}, plain "
                f"{spread(tp)}, F.interpolate {spread(tl)} ({parts} call(s)), bound "
                f"{bound:.4f} ms ({k2_by}), {bound / statistics.median(t):.1%} of bound")
            del x, inputs, views
    report["rows"] = rows
    report["bound_by"] = {"K1": k1_by, "K2": k2_by}
    log("K1 has no single PyTorch call computing InstanceNorm+LeakyReLU (library_ms null).")
    log(f"per b{batch} forward (sum over the main-path calls of the medians): "
        + "; ".join(f"{k}: kernel {v[0]:.3f} ms, plain {v[1]:.3f} ms, bound {v[2]:.3f} ms"
                    for k, v in rows.items()))
    log(f"K1 bound by pass per b{batch} forward: statistics (read x) {k1_split[0]:.3f} ms, "
        f"apply (read x, write y) {k1_split[1]:.3f} ms")


def kernels_line() -> dict:
    rows = report.get("rows", {})
    counts = report.get("launches", {})
    bound_by = report.get("bound_by", {})
    meta = [
        ("K1 fused_instance_norm (InstanceNorm+LeakyReLU fwd)",
         "unet_implementations_tpu_torch/kernels/csrc/instance_norm.cu",
         "unet_implementations_tpu/kernels/instance_norm.py:80", "K1", "k1_err"),
        ("K2 upsample2x_nhwc_fast (2x bilinear, dense fwd)",
         "unet_implementations_tpu_torch/kernels/csrc/upsample.cu",
         "unet_implementations_tpu/kernels/upsample.py:118", "K2", "k2_err"),
    ]
    out = []
    for name, source, replaces, key, err in meta:
        ms, plain_ms, bound_ms, library_ms = rows.get(key, [None] * 4)
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts.get(key), "max_abs_err": report.get(err),
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
    t0 = time.perf_counter()
    phase_build()
    if not failures:
        phase_kernels()
        phase_slice()
        if "model" in report:
            phase_e2e()
            phase_times()
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
