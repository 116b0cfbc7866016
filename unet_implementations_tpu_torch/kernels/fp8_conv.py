"""The fp8 convolution of the fp8 conv mode, forward (CUDA, ``csrc/fp8_conv.cu``).

Replaces no TPU kernel: ``unet_implementations_tpu/ops/quant.py::qconv`` is an
XLA convolution with fp8 operands. The card has no library call for it
(``F.conv2d`` takes no float8 operand; ``torch._scaled_mm``'s cuBLASLt GEMM
refuses e5m2 x e5m2, JAX's default pair), so ``ops/quant.py::qconv`` launches
this hand-written one. ``fp8_conv`` computes, on an NHWC bf16 or fp16 ``x``
and the canonical (Cout, Cin, kh, kw) kernel in x's dtype,

    y = ((conv(q(x), q(w)) in float32, rounded to x's dtype) [+ residual]) [+ bias]

with each addition in x's dtype, as JAX's ``qconv(...) + bias.astype(dtype)``
and its split conv's ``y + yi`` do. ``q`` is the cast to e5m2 or e4m3fn as
XLA does it (``fp8_bits``): torch's ``.to(torch.float8_e4m3fn)`` saturates
above 464 where XLA gives NaN, and gives NaN bytes of another sign, so the
plain version fixes those bytes. The bias is never quantized.

Padding is explicit, (top, bottom, left, right); stride 1 or 2; any kh x kw.
Bound: operations, the fp8 multiply-adds at the tensor cores' fp8 rate, or
bytes (x read once, y written once, the fp8 kernel), the larger
(``conv_bytes``, ``conv_flops``).

Two kernels, chosen by shape alone (``wgmma_plan``; no switch, no fallback):
``fp8_conv_wgmma_kernel`` takes every call whose Cin and Cout are multiples
of 32, the general ``fp8_conv_kernel`` the rest (the model's first conv, Cin
3 or 12, and its head, Cout 3 or 12). The wgmma kernel is a persistent,
warp-specialised implicit GEMM: a producer warpgroup copies an item's window
of x (its flat output rows plus the taps' reach, per parity plane) 16
channels at a time, casts each value once to fp8 as XLA does and stores the
float16 of that fp8 value; two consumer warpgroups run f16 wgmma from
descriptors shifted by each tap, accumulating in float32. f16 holds every
fp8 value exactly; fp8 wgmma would not do: it keeps about 13 bits of a k32
sum (``tools/wgmma_precision.py``), which misses the exact-sum gate of
``chip_smoke.py`` phase 16 (a). The plan (N-tile, m-tiles an item, ring
depths) is sized to a Hopper block's shared memory (``SMEM_BYTES``); the
weight is packed per call (``pack_weight``, order ``pack_order``, plain
version ``pack_weight_plain``). ``csrc/fp8_conv.cu``'s note has the rest.

On a CPU tensor ``fp8_conv`` runs the plain version (``_plain_conv``: the
casts, float32 ``F.conv2d`` on the fp8 values, whose products are exact in
float32, and the roundings); on CUDA tensors it launches the kernel or
raises. It is the operator ``torch.ops.unet_torch.fp8_conv`` (CUDA: the
weight's fp8 pack and the conv launch, counted there; CPU: the plain version;
fake tensors: the output shape), so an artifact exported with the mode on
replays the quantized convs. It has no backward. ``fp8_conv.launches``
counts both kernels' launches, ``fp8_conv.wgmma_launches`` the wgmma
kernel's.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from unet_implementations_tpu_torch.kernels import _build

# The fp8 dtypes and their codes in csrc/fp8_conv.cu.
FP8_CODES = {torch.float8_e5m2: 0, torch.float8_e4m3fn: 1}
# Activation dtypes the kernel takes, by their codes in csrc/common.cuh.
_DTYPE_CODES = {torch.bfloat16: 1, torch.float16: 2}
# e4m3fn has no inf: XLA casts a value past the midpoint above its largest
# finite value, 448, to NaN.
E4M3_NAN_ABOVE = 464.0
_NAN = 0x7F
# The k-step of the kernel: K = kh*kw*Cin is zero-padded to a multiple of it.
K_STEP = 32

# The wgmma kernel's plan (``wgmma_plan``): N-tile widths, the input
# channels of a ring stage (one k16 step of every tap), the deepest ring, the
# producer's raw ring sizes (slots of one step: 512 pixels x 16 channels of
# x), the shared memory of a Hopper block (H100, H200), and each stage's two
# mbarriers. The kernel takes Cin and Cout in multiples of WGMMA_MULTIPLE.
WGMMA_TILE_N = (128, 64, 32)
WGMMA_CHUNK = 16
WGMMA_MULTIPLE = 32
WGMMA_MAX_STAGES = 4
WGMMA_RINGS = (4, 2)
_STEP_BYTES = 512 * WGMMA_CHUNK * 2
SMEM_BYTES = 232448
_BARRIER_BYTES = 16

_CONV_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 15 + [ctypes.c_void_p]
_PACK_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_WGMMA_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 18 + [ctypes.c_void_p]
_CAST_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_longlong,
                                                                 ctypes.c_void_p]


def fp8_bits_plain(x: torch.Tensor, fp8: torch.dtype) -> torch.Tensor:
    """The fp8 bytes (uint8) of ``x`` as XLA casts it: torch's round to
    nearest even, then e4m3fn's NaN (0x7f with x's sign) for a NaN or a
    magnitude above 464, and e5m2's NaN as 0x7f."""
    bits = x.to(fp8).view(torch.uint8)
    nan = torch.isnan(x)
    if fp8 == torch.float8_e4m3fn:
        sign = torch.signbit(x).to(torch.uint8) << 7
        return torch.where(nan | (x.abs() > E4M3_NAN_ABOVE), sign | _NAN, bits)
    return torch.where(nan, torch.full_like(bits, _NAN), bits)


def fp8_values(bits: torch.Tensor, fp8: torch.dtype) -> torch.Tensor:
    """fp8 bytes as float32 values (exact)."""
    return bits.view(fp8).to(torch.float32)


def _check_dtypes(x: torch.Tensor, fp8: torch.dtype, name: str) -> None:
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} takes bfloat16 or float16, got {x.dtype}")
    if fp8 not in FP8_CODES:
        raise TypeError(f"{name} casts to float8_e5m2 or float8_e4m3fn, got {fp8}")


def fp8_bits(x: torch.Tensor, fp8: torch.dtype) -> torch.Tensor:
    """The fp8 bytes of x: the kernel's own cast on a CUDA tensor (one
    launch of ``unet_fp8_cast``, not counted), the plain version on a CPU
    one. The checks hold the two to each other bit for bit."""
    _check_dtypes(x, fp8, "fp8_bits")
    if not _build.uses_kernel(x):
        return fp8_bits_plain(x, fp8)
    x = x.contiguous()
    q = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    fn = _build.kernel_function("unet_fp8_cast", _CAST_ARGTYPES)
    with _build.on_device(x.device):
        code = fn(x.data_ptr(), q.data_ptr(), _DTYPE_CODES[x.dtype], FP8_CODES[fp8], x.numel(),
                  _build.stream_of(x))
    _build.check(code, "unet_fp8_cast")
    return q


def output_size(x_shape, weight_shape, stride: int, padding: Sequence[int]) -> tuple:
    """(B, Ho, Wo, Cout) of the conv of an NHWC x."""
    b, h, w, _ = x_shape
    cout, _, kh, kw = weight_shape
    t, bo, le, r = padding
    return b, (h + t + bo - kh) // stride + 1, (w + le + r - kw) // stride + 1, cout


def conv_flops(x_shape, weight_shape, stride: int, padding: Sequence[int]) -> int:
    """2 · multiply-adds of the conv (padding taps included, as the kernel
    multiplies them)."""
    b, ho, wo, cout = output_size(x_shape, weight_shape, stride, padding)
    _, cin, kh, kw = weight_shape
    return 2 * b * ho * wo * cout * cin * kh * kw


def conv_bytes(x_shape, weight_shape, stride: int, padding: Sequence[int], itemsize: int,
               residual: bool = False, bias: bool = False) -> int:
    """x read once, the fp8 kernel read once, y written once (and the
    residual read once, the bias once)."""
    out = math.prod(output_size(x_shape, weight_shape, stride, padding))
    return ((math.prod(x_shape) + out * (2 if residual else 1)) * itemsize
            + math.prod(weight_shape) + (weight_shape[0] * itemsize if bias else 0))


class WgmmaPlan(NamedTuple):
    """How ``fp8_conv_wgmma_kernel`` takes a call: N-tiles of ``bn`` output
    channels, ``tiles`` m-tiles of 64 flat rows per consumer warpgroup (an
    item is 128 · tiles rows), a ring of ``stages`` slots of ``stage_bytes``,
    and the producer's raw ring of ``ring`` slots (``ring`` - 1 steps of
    loads in flight)."""

    bn: int
    tiles: int
    stages: int
    stage_bytes: int
    ring: int


def wgmma_geometry(x_shape, weight_shape, stride: int, padding: Sequence[int]) -> tuple:
    """(hq, wq, offsets) of the wgmma kernel's flat view of a call: each image
    as parity planes (one at stride 1, up to four at stride 2) of hq × wq
    pixels, output pixel (oy, ox) as flat row oy·wq + ox, and tap (ky, kx) as
    a flat offset into plane (ky % stride, kx % stride); ``offsets`` holds
    each plane's largest (``csrc/fp8_conv.cu``, ``wg::Conv``)."""
    _, ho, wo, _ = output_size(x_shape, weight_shape, stride, padding)
    _, _, kh, kw = weight_shape
    hq, wq = ho + (kh - 1) // stride, wo + (kw - 1) // stride
    offsets = [(kh - 1 - py) // stride * wq + (kw - 1 - px) // stride
               for py in range(min(stride, kh)) for px in range(min(stride, kw))]
    return hq, wq, offsets


def wgmma_plan(x_shape, weight_shape, stride: int,
               padding: Sequence[int]) -> Optional[WgmmaPlan]:
    """The plan of ``fp8_conv_wgmma_kernel`` for a call, or None where the
    call goes to the general kernel: Cin or Cout not a multiple of 32,
    another stride than 1 or 2, or no plan whose ring holds two stages.

    A stage holds 16 input channels of an item's window (its 128 · tiles
    flat rows plus the plane's largest tap offset, in every plane) and the packed
    weights of those channels for every tap and one N-tile, all as f16. A
    consumer holds up to 128 accumulator floats a thread: tiles · bn ≤ 256.
    Each plan takes the deepest raw ring (4 steps of 512 pixels, or 2) that
    leaves room for two stages, then as many stages as fit. Of the plans that
    keep 3 steps of loads in flight (or, if none does, of all that fit), the
    one that casts the fewest window bytes per output value (the wider
    N-tile on a tie)."""
    cout, cin, kh, kw = weight_shape
    if cin % WGMMA_MULTIPLE or cout % WGMMA_MULTIPLE or stride not in (1, 2):
        return None
    hq, wq, offsets = wgmma_geometry(x_shape, weight_shape, stride, padding)
    # The kernel's flat rows and window pixels are 32-bit ints.
    if x_shape[0] * hq * wq + 2 * (1024 + max(offsets)) + 8 >= 2 ** 31 - 1:
        return None
    best, best_key = None, None
    for bn in WGMMA_TILE_N:
        if cout % bn:
            continue
        for tiles in range(256 // bn, 0, -1):
            bm = 128 * tiles
            window = sum(-(-(bm + off) // 8) * 8 for off in offsets)
            stage = kh * kw * WGMMA_CHUNK * bn * 2 + 2 * window * 16
            rings = [r for r in WGMMA_RINGS
                     if 2 * (stage + _BARRIER_BYTES) + r * _STEP_BYTES <= SMEM_BYTES]
            if not rings:
                continue
            stages = min(WGMMA_MAX_STAGES,
                         (SMEM_BYTES - rings[0] * _STEP_BYTES) // (stage + _BARRIER_BYTES))
            # Loads in flight first, then the window bytes cast per output value.
            key = (rings[0] < 4, window / (bm * bn))
            if best_key is None or key < best_key:
                best, best_key = WgmmaPlan(bn, tiles, stages, stage, rings[0]), key
    return best


def wgmma_applicable(x_shape, weight_shape, stride: int, padding: Sequence[int]) -> bool:
    """Whether a call goes to ``fp8_conv_wgmma_kernel`` (else to the
    general kernel): decided by shape alone."""
    return wgmma_plan(x_shape, weight_shape, stride, padding) is not None


def pack_order(cout: int, cin: int, kh: int, kw: int, bn: int) -> torch.Tensor:
    """The flat index, into the canonical (Cout, Cin, kh, kw) kernel, of each
    value of the wgmma kernel's packed weights, in the order
    (Cout/bn, Cin/16, kh·kw, 2, bn/8, 8, 8).

    Element [nt, cc, tap, k8, n8, nr, kr] is ``w[nt·bn + 8·n8 + nr, 16·cc +
    8·k8 + kr, tap // kw, tap % kw]``: the GEMM's B with K ordered by
    16-channel chunk, then tap, then 8-channel group, and N = Cout, as
    wgmma's no-swizzle K-major core matrices of f16 (8 output channels × 8
    input channels, 128 bytes). The block of one (N-tile, chunk) is
    kh·kw·16·bn values, one ring stage's bulk copy; within it a tap's two k8
    halves are bn·16 bytes apart (the leading byte offset), its core matrices
    along N 128 bytes (the stride byte offset)."""
    if cin % WGMMA_CHUNK or cout % bn:
        raise ValueError(f"pack_order takes Cin a multiple of {WGMMA_CHUNK} and Cout of "
                         f"{bn}, got {cin} and {cout}")
    idx = torch.arange(cout * cin * kh * kw).reshape(cout // bn, bn // 8, 8, cin // WGMMA_CHUNK,
                                                     2, 8, kh * kw)
    # (nt, n8, nr, cc, k8, kr, tap) -> (nt, cc, tap, k8, n8, nr, kr)
    return idx.permute(0, 3, 6, 4, 1, 2, 5).reshape(-1)


def f16_of_fp8(bits: torch.Tensor, fp8: torch.dtype) -> torch.Tensor:
    """fp8 bytes as the float16 of the same values (exact: float16 holds
    every e5m2 and e4m3fn value), a NaN as float16's NaN 0x7e00 with the
    byte's sign: the operands of the wgmma kernel."""
    half = fp8_values(bits, fp8).to(torch.float16).view(torch.int16)
    nan = ((bits.to(torch.int16) & 0x80) << 8) | 0x7E00
    return torch.where(torch.isnan(fp8_values(bits, fp8)), nan, half).view(torch.float16)


def pack_weight_plain(weight: torch.Tensor, fp8: torch.dtype, bn: int) -> torch.Tensor:
    """The wgmma kernel's packed weights (float16, ``pack_order``) from the
    plain cast: what ``unet_fp8_pack_weight_wgmma`` writes, bit for bit."""
    cout, cin, kh, kw = weight.shape
    order = pack_order(cout, cin, kh, kw, bn).to(weight.device)
    return f16_of_fp8(fp8_bits_plain(weight, fp8).reshape(-1)[order], fp8)


def pack_weight(weight: torch.Tensor, fp8: torch.dtype, bn: int) -> torch.Tensor:
    """The packed weights of the wgmma kernel: ``unet_fp8_pack_weight_wgmma``
    on a CUDA tensor (one launch, not counted), the plain version on a CPU
    one."""
    _check_dtypes(weight, fp8, "pack_weight")
    if not _build.uses_kernel(weight):
        return pack_weight_plain(weight, fp8, bn)
    weight = weight.contiguous()
    cout, cin, kh, kw = weight.shape
    wq = torch.empty(weight.numel(), dtype=torch.float16, device=weight.device)
    fn = _build.kernel_function("unet_fp8_pack_weight_wgmma", _PACK_ARGTYPES)
    with _build.on_device(weight.device):
        code = fn(weight.data_ptr(), wq.data_ptr(), _DTYPE_CODES[weight.dtype], FP8_CODES[fp8],
                  cout, cin, kh, kw, bn, _build.stream_of(weight))
    _build.check(code, "unet_fp8_pack_weight_wgmma")
    return wq


def _plain_conv(x, weight, bias, residual, stride: int, padding: Sequence[int],
                fp8: torch.dtype) -> torch.Tensor:
    """The plain version: the fp8 casts, F.conv2d in float32 on their values
    (TF32 off on the card), rounded to x's dtype, then the residual and the
    bias added in x's dtype."""
    xq = fp8_values(fp8_bits_plain(x, fp8), fp8).permute(0, 3, 1, 2)
    wq = fp8_values(fp8_bits_plain(weight, fp8), fp8)
    t, b, le, r = padding
    y = F.conv2d(F.pad(xq, (le, r, t, b)), wq, stride=stride)
    y = y.permute(0, 2, 3, 1).to(x.dtype)
    if residual is not None:
        y = residual + y
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y.contiguous()


def _aligned(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``t`` contiguous with its data 16-byte aligned (a copy if it was not)."""
    if t is None:
        return None
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _cuda_conv(x, weight, bias, residual, stride: int, padding: Sequence[int],
               fp8: torch.dtype, general: bool = False) -> torch.Tensor:
    """The weight's fp8 pack and the conv launch (counted), on CUDA tensors:
    ``fp8_conv_wgmma_kernel`` where ``wgmma_plan`` has a plan, the
    general kernel otherwise. ``general`` sends the call to the general
    kernel whatever its shape: the timing yardstick of ``chip_smoke.py``
    phase 16 (c), on no path of the package."""
    _check(x, weight, bias, residual, stride, padding, fp8)
    plan = None if general else wgmma_plan(x.shape, weight.shape, stride, padding)
    x, weight = x.contiguous(), weight.contiguous()
    cout, cin, kh, kw = weight.shape
    shape = output_size(x.shape, weight.shape, stride, padding)
    y = torch.empty(shape, dtype=x.dtype, device=x.device)
    dtype, code8 = _DTYPE_CODES[x.dtype], FP8_CODES[fp8]
    stream = _build.stream_of(x)
    residual = None if residual is None else residual.contiguous()
    if plan is not None:
        x, bias, residual = _aligned(x), _aligned(bias), _aligned(residual)
        wq = pack_weight(weight, fp8, plan.bn)
        conv = _build.kernel_function("unet_fp8_conv_wgmma_fwd", _WGMMA_ARGTYPES)
        with _build.on_device(x.device):
            code = conv(x.data_ptr(), wq.data_ptr(), 0 if bias is None else bias.data_ptr(),
                        0 if residual is None else residual.data_ptr(), y.data_ptr(), dtype,
                        code8, x.shape[0], x.shape[1], x.shape[2], cin, shape[1], shape[2],
                        cout, kh, kw, stride, padding[0], padding[2], plan.bn, plan.tiles,
                        plan.stages, plan.ring, stream)
        _build.check(code, "unet_fp8_conv_wgmma_fwd")
        fp8_conv.wgmma_launches += 1
        fp8_conv.launches += 1
        return y
    kpad = -(-kh * kw * cin // K_STEP) * K_STEP
    wq = torch.empty((cout, kpad), dtype=torch.uint8, device=x.device)
    pack = _build.kernel_function("unet_fp8_pack_weight", _PACK_ARGTYPES)
    conv = _build.kernel_function("unet_fp8_conv_fwd", _CONV_ARGTYPES)
    with _build.on_device(x.device):
        code = pack(weight.data_ptr(), wq.data_ptr(), dtype, code8, cout, cin, kh, kw, kpad,
                    stream)
        _build.check(code, "unet_fp8_pack_weight")
        code = conv(x.data_ptr(), wq.data_ptr(), 0 if bias is None else bias.data_ptr(),
                    0 if residual is None else residual.data_ptr(), y.data_ptr(), dtype, code8,
                    x.shape[0], x.shape[1], x.shape[2], cin, shape[1], shape[2], cout, kh, kw,
                    stride, padding[0], padding[2], kpad, stream)
    _build.check(code, "unet_fp8_conv_fwd")
    fp8_conv.launches += 1
    return y


def _check(x, weight, bias, residual, stride: int, padding: Sequence[int],
           fp8: torch.dtype) -> None:
    _check_dtypes(x, fp8, "fp8_conv")
    if x.ndim != 4 or weight.ndim != 4 or weight.shape[1] != x.shape[3]:
        raise ValueError(f"fp8_conv takes x (B, H, W, Cin) and weight (Cout, Cin, kh, kw), got "
                         f"{tuple(x.shape)} and {tuple(weight.shape)}")
    if weight.dtype != x.dtype or any(t is not None and t.dtype != x.dtype
                                      for t in (bias, residual)):
        raise TypeError("fp8_conv takes the weight, bias and residual in x's dtype")
    if stride not in (1, 2) or len(padding) != 4 or min(padding) < 0:
        raise ValueError(f"fp8_conv takes stride 1 or 2 and 4 paddings >= 0, got {stride}, "
                         f"{tuple(padding)}")
    shape = output_size(x.shape, weight.shape, stride, padding)
    if min(shape) <= 0:
        raise ValueError(f"fp8_conv: empty output {shape}")
    if bias is not None and tuple(bias.shape) != (weight.shape[0],):
        raise ValueError(f"fp8_conv: bias {tuple(bias.shape)} for {weight.shape[0]} channels")
    if residual is not None and tuple(residual.shape) != shape:
        raise ValueError(f"fp8_conv: residual {tuple(residual.shape)}, output {shape}")


_FP8_NAMES = {torch.float8_e5m2: "e5m2", torch.float8_e4m3fn: "e4m3"}
_FP8_BY_NAME = {v: k for k, v in _FP8_NAMES.items()}

# The conv as an operator (``torch.ops.unet_torch.fp8_conv``): the launch on
# CUDA tensors, the plain version on CPU tensors, the output shape under fake
# tensors (one ``torch.export`` node per call). No backward, as the mode is
# forward-only in the port.
_LIB = _build.op_library()
_LIB.define("fp8_conv(Tensor x, Tensor weight, Tensor? bias, Tensor? residual, int stride, "
            "int[] padding, str fp8) -> Tensor")
_LIB.impl("fp8_conv", lambda x, w, b, r, s, p, f: _cuda_conv(x, w, b, r, s, p, _FP8_BY_NAME[f]),
          "CUDA")
_LIB.impl("fp8_conv", lambda x, w, b, r, s, p, f: _plain_conv(x, w, b, r, s, p, _FP8_BY_NAME[f]),
          "CPU")


@torch.library.register_fake(f"{_build.OPS_NAMESPACE}::fp8_conv", lib=_LIB)
def _fake_op(x, weight, bias, residual, stride, padding, fp8):
    return x.new_empty(output_size(x.shape, weight.shape, stride, padding))


def fp8_conv(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
             residual: Optional[torch.Tensor] = None, stride: int = 1,
             padding: Sequence[int] = (0, 0, 0, 0),
             fp8: torch.dtype = torch.float8_e5m2) -> torch.Tensor:
    """The fp8 conv of an NHWC ``x`` (bf16 or fp16) with ``weight`` (Cout,
    Cin, kh, kw) in x's dtype, ``padding`` (top, bottom, left, right):
    (B, Ho, Wo, Cout) in x's dtype, plus ``residual`` (that shape) and
    ``bias`` (Cout,), each added in x's dtype."""
    tensors = [t for t in (x, weight, bias, residual) if t is not None]
    _build.uses_kernel(*tensors)  # raises on another device, or a mix
    _check(x, weight, bias, residual, stride, padding, fp8)
    return torch.ops.unet_torch.fp8_conv(x, weight, bias, residual, int(stride),
                                         [int(p) for p in padding], _FP8_NAMES[fp8])


# Kernel launches since the count was last set to 0 (CPU calls do not count):
# both kernels', and fp8_conv_wgmma_kernel's alone.
fp8_conv.launches = 0
fp8_conv.wgmma_launches = 0
