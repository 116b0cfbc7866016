"""K3: the fused tail of a space-to-depth ConvBlock, forward (CUDA,
``csrc/s2d_region.cu``).

Replaces ``unet_implementations_tpu/kernels/s2d_region.py::_pallas_tail``
(``_region_kernel``). Every s2d ConvBlock of an inference forward ends in
``IN1 -> LeakyReLU -> conv_1 -> IN2 -> LeakyReLU``; ``fused_s2d_tail``
computes that chain on conv_0's q-major output (B, H′, W′, 4C), with both
norms pooling the four sub-pixels of each original channel. conv_1's bias is
not taken: IN2 subtracts each channel's mean, which removes it exactly.
Three calls per forward of the s2d 6-stage model (encoder_0, decoder_3,
decoder_4).

The TPU kernel kept one image in VMEM; an SM's 227 KB does not hold one. The
CUDA entry point runs K1's statistics passes for IN1, a hand-written 3×3 conv
in the full-resolution geometry that normalizes and activates its input as it
loads it and sums Σy, Σy² of its rounded output, then K1's finalize and apply
passes for IN2. In bf16 the conv is a persistent, warp-specialised wgmma
kernel: a producer warpgroup fills a shared-memory ring with the normalized,
activated halo tile of each 4-row × 64-column segment, and two consumer
warpgroups multiply it, at nine shifted views, by conv_1's kernel, which
``pack_weights`` lays out for one bulk copy into shared memory. In float32
(the 1e-4 correctness mode) the conv runs on the CUDA cores. Bound: bytes,
one read of x and one write of y (see the source).

The plain version ``_torch_tail`` follows the JAX ``jnp_tail`` op for op:
IN1 rounded to the dtype, LeakyReLU in the dtype, the conv's output rounded
to the dtype, IN2's statistics from those rounded values, LeakyReLU in the
dtype. K1's apply pass activates before it rounds, so a negative output may
differ from the plain version by one ulp of the dtype.

On a CPU tensor ``fused_s2d_tail`` runs the plain version; on a CUDA tensor
it launches the kernel or raises (C must be 8, 16, 32 or 64). It is the
operator ``torch.ops.unet_torch.s2d_tail`` (CUDA: the launch, which makes
its own scratch and packs conv_1's kernel, counted there; CPU: the plain
version; fake tensors: the output shape), so ``torch.export`` captures each
call as one node. Forward only: a CUDA call that autograd would record
raises; on the CPU such a call runs the plain ops under autograd. ``region_applicable`` says
whether a call is one the kernel takes, as the JAX ``region_applicable``
does: a block takes the fused tail only then, and runs its module path
otherwise.
"""

from __future__ import annotations

import ctypes
import math

import torch

from unet_implementations_tpu_torch.kernels import _build
from unet_implementations_tpu_torch.ops.s2d import conv_s2d, instance_norm_s2d

# Original channel counts the CUDA kernel takes.
CHANNELS = (8, 16, 32, 64)
# IN2's rows of partials per image (csrc/s2d_region.cu): the bf16 conv writes
# kPartialRows = 4 per band of kRows = 4 full-resolution rows, the float32
# conv one per strip of kTileH = 8 rows.
_BAND_ROWS, _ROWS_PER_BAND, _STRIP_ROWS = 4, 4, 8
# Input channels of one wgmma k-step, and the least width the bf16 kernel
# multiplies (C = 8 is padded to it with zeros).
_K_STEP = 16
# Bytes of x a block of IN1's statistics pass reduces (as K1).
_STATS_CHUNK_BYTES = 64 * 1024

_ARGTYPES = [ctypes.c_void_p] * 14 + [
    ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
]


def _lrelu_in_dtype(y: torch.Tensor, negative_slope: float) -> torch.Tensor:
    """``jnp.where(y >= 0, y, y * jnp.asarray(neg, y.dtype))``: the slope is
    rounded to y's dtype and the product to y's dtype."""
    slope = torch.tensor(negative_slope, dtype=y.dtype, device=y.device)
    return torch.where(y >= 0, y, y * slope)


def activated_input(x, scale1, bias1, eps, negative_slope):
    """``lrelu(IN1(x))`` as the plain version computes it: the norm rounded to
    x's dtype, the activation in that dtype. The conv's input."""
    return _lrelu_in_dtype(instance_norm_s2d(x, scale1, bias1, eps, out_dtype=x.dtype),
                           negative_slope)


def pack_weights(weight2: torch.Tensor) -> torch.Tensor:
    """conv_1's (C, C, 3, 3) kernel in the order the bf16 conv copies it into
    shared memory: (9, CP/16, 2, CP/8, 8, 8) with CP = max(C, 16), zero where
    an input or output channel is C or more.

    Element [tap, kc, k8, n8, nr, kr] is ``weight2[8·n8 + nr, 16·kc + 8·k8 +
    kr, tap // 3, tap % 3]``: the GEMM's B with K = 9·CP rows (tap-major) and
    N = CP columns, as wgmma's no-swizzle K-major core matrices (8 output
    channels × 8 input channels, 128 bytes). The block of one (tap, k-step)
    is CP·32 bytes; its two k8 halves are CP·16 bytes apart (the leading byte
    offset), its core matrices along N 128 bytes (the stride byte offset).
    """
    c = weight2.shape[0]
    if weight2.ndim != 4 or tuple(weight2.shape) != (c, c, 3, 3) or c not in CHANNELS:
        raise ValueError(f"pack_weights takes a (C, C, 3, 3) kernel with C in {CHANNELS}, "
                         f"got {tuple(weight2.shape)}")
    cp = max(c, _K_STEP)
    w = weight2.new_zeros((cp, cp, 3, 3))
    w[:c, :c] = weight2
    # (co, ci, ky, kx) -> (tap, kc, k8, kr, n8, nr) -> (tap, kc, k8, n8, nr, kr)
    p = w.permute(2, 3, 1, 0).reshape(9, cp // _K_STEP, 2, 8, cp // 8, 8)
    return p.permute(0, 1, 2, 4, 5, 3).contiguous()


def _torch_tail(x, scale1, bias1, weight2, scale2, bias2, eps, negative_slope,
                carried_ulp=False):
    """Plain version: the op sequence of the JAX ``jnp_tail``.

    x: (B, H′, W′, 4C) q-major; weight2: conv_1's (C, C, 3, 3) kernel;
    scale*/bias*: (C,) float32.

    With ``carried_ulp`` it also returns, per output element, what one ulp
    (in x's dtype) of the conv's rounded output moves the result by through
    IN2 and the activation: ``ulp(conv) · |scale2 · rstd2|``, times the slope
    where the result is negative and that move cannot cross zero. A kernel
    that sums the conv in another order may round a conv output the other
    way; this is what that costs.
    """
    y = activated_input(x, scale1, bias1, eps, negative_slope)
    conv = conv_s2d(y, weight2.to(y.dtype), None)
    y = instance_norm_s2d(conv, scale2, bias2, eps, out_dtype=x.dtype)
    out = _lrelu_in_dtype(y, negative_slope)
    if not carried_ulp:
        return out
    b, hp, wp, c4 = conv.shape
    cf = conv.to(torch.float32).reshape(b, hp, wp, 4, c4 // 4)
    mean = cf.mean(dim=(1, 2, 3), keepdim=True)
    var = torch.clamp((cf * cf).mean(dim=(1, 2, 3), keepdim=True) - mean * mean, min=0.0)
    gain = (torch.rsqrt(var + eps) * scale2.to(torch.float32)).abs().reshape(b, 1, 1, 1, -1)
    mag = cf.abs().clamp_min(torch.finfo(torch.float32).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(mag))) * torch.finfo(x.dtype).eps
    carried = (ulp * gain).reshape(b, hp, wp, c4)
    outf = out.to(torch.float32)
    full = (outf >= 0) | (outf.abs() <= carried * negative_slope)
    return out, torch.where(full, carried, carried * negative_slope)


def _check(x, scale1, bias1, weight2, scale2, bias2) -> None:
    b, hp, wp, c4 = x.shape
    c = c4 // 4
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"fused_s2d_tail takes float32 or bfloat16, got {x.dtype}")
    if c4 % 4 or c not in CHANNELS:
        raise ValueError(f"fused_s2d_tail takes 4C channels with C in {CHANNELS}, got {c4}")
    if tuple(weight2.shape) != (c, c, 3, 3):
        raise ValueError(f"conv_1's kernel must be ({c}, {c}, 3, 3), got {tuple(weight2.shape)}")
    for t in (scale1, bias1, scale2, bias2):
        if tuple(t.shape) != (c,):
            raise ValueError(f"norm affines must have {c} entries, got {tuple(t.shape)}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("fused_s2d_tail needs x contiguous at a 16-byte aligned address")


def tail_bytes(shape, itemsize: int) -> int:
    """The least bytes of one call (and of its conv launch alone): x, the
    (B, H', W', 4C) conv_0 output, read once and the output of its shape
    written once (its roofline bound, ``chip_smoke.py`` and
    ``utils/profiling.py``)."""
    return 2 * math.prod(shape) * itemsize


def tail_conv_flops(shape) -> int:
    """The multiply-adds of the tail's 3x3 conv (C in, C out at each of the
    4 sub-pixels), counted as 2 operations each."""
    return 2 * math.prod(shape) * 9 * (shape[-1] // 4)


def tail_norm_operations(shape) -> int:
    """The norms' float32 operations per element: IN1 and IN2 sums (3 + 3),
    IN1's normalize and activation (6), IN2's apply (5)."""
    return 17 * math.prod(shape)


def kernel_weights(weight2: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """conv_1's kernel as the conv launch takes it: packed (``pack_weights``)
    in bf16, (3, 3, C_in, C_out) in float32."""
    if dtype == torch.bfloat16:
        return pack_weights(weight2.to(dtype))
    return weight2.to(dtype).permute(2, 3, 1, 0).contiguous()


def _partial_rows(dtype: torch.dtype, hp: int) -> int:
    """IN2's rows of partials per image (``nrows2`` in the source)."""
    if dtype == torch.bfloat16:
        return _ROWS_PER_BAND * -(-2 * hp // _BAND_ROWS)
    return -(-2 * hp // _STRIP_ROWS)


def tail_buffers(x: torch.Tensor) -> dict:
    """The outputs and float32 scratch of one launch on ``x``."""
    b, hp, wp, c4 = x.shape
    f32 = dict(dtype=torch.float32, device=x.device)
    chunk_px = max(1, _STATS_CHUNK_BYTES // (c4 * x.element_size()))
    nchunk = -(-hp * wp // chunk_px)
    return {"chunk_px": chunk_px, "nchunk": nchunk,
            "y_conv": torch.empty_like(x), "out": torch.empty_like(x),
            "partials1": torch.empty((b, nchunk, 2, c4), **f32),
            "partials2": torch.empty((b, _partial_rows(x.dtype, hp), 2, c4), **f32),
            # mean1, rstd1, mean2, rstd2
            "stats": [torch.empty((b, c4), **f32) for _ in range(4)]}


def launch_tail(x, scale1, bias1, w, scale2, bias2, buffers: dict, eps: float,
                negative_slope: float, conv_only: bool = False) -> torch.Tensor:
    """One launch of the CUDA entry point on checked inputs, ``w`` from
    ``kernel_weights``; returns ``buffers["out"]``. With ``conv_only`` only
    the conv runs, on IN1's statistics that an earlier full launch left in
    ``buffers`` (its output is ``buffers["y_conv"]``): for timing the conv
    alone. Counts no launch."""
    b, hp, wp, c4 = x.shape
    affines = [t.to(torch.float32).contiguous() for t in (scale1, bias1, scale2, bias2)]
    stats = buffers["stats"]
    fn = _build.kernel_function("unet_s2d_tail_fwd", _ARGTYPES)
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), w.data_ptr(), *(t.data_ptr() for t in affines),
                  buffers["y_conv"].data_ptr(), buffers["out"].data_ptr(),
                  buffers["partials1"].data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
                  buffers["partials2"].data_ptr(), stats[2].data_ptr(), stats[3].data_ptr(),
                  _build.DTYPE_CODES[x.dtype], b, hp, wp, c4 // 4, buffers["chunk_px"],
                  buffers["nchunk"], buffers["partials2"].shape[1], eps, negative_slope,
                  int(conv_only), _build.stream_of(x))
    _build.check(code, "unet_s2d_tail_fwd")
    return buffers["out"]


def _cuda_forward(x, scale1, bias1, weight2, scale2, bias2, eps, negative_slope):
    """The launch (counted), on CUDA tensors: the outputs and scratch
    (``tail_buffers``) and conv_1's packed kernel (``kernel_weights``) are
    made here, per call."""
    _build.uses_kernel(x, scale1, bias1, weight2, scale2, bias2)  # raises on a mix
    x = x.contiguous()
    _check(x, scale1, bias1, weight2, scale2, bias2)
    out = launch_tail(x, scale1, bias1, kernel_weights(weight2, x.dtype), scale2, bias2,
                      tail_buffers(x), eps, negative_slope)
    fused_s2d_tail.launches += 1
    return out


def region_applicable(x: torch.Tensor, scale1: torch.Tensor, bias1: torch.Tensor,
                      weight2: torch.Tensor, scale2: torch.Tensor, bias2: torch.Tensor) -> bool:
    """Whether ``fused_s2d_tail(x, ...)`` is a call the kernel takes: x is
    (B, H′, W′, 4C) float32 or bfloat16 with C in ``CHANNELS``, conv_1's
    ``weight2`` is (C, C, 3, 3), and autograd would not record it (grad mode
    is off, or neither x nor a parameter requires grad)."""
    if x.ndim != 4 or x.shape[-1] % 4 or x.shape[-1] // 4 not in CHANNELS:
        return False
    c = x.shape[-1] // 4
    if x.dtype not in _build.DTYPE_CODES or tuple(weight2.shape) != (c, c, 3, 3):
        return False
    return not _build.records_grad(x, scale1, bias1, weight2, scale2, bias2)


# The tail as an operator (``torch.ops.unet_torch.s2d_tail``): the launch on
# CUDA tensors, the plain version on CPU tensors, the output shape under fake
# tensors (one ``torch.export`` node per call). It has no backward, as in JAX.
_LIB = _build.op_library()
_LIB.define("s2d_tail(Tensor x, Tensor scale1, Tensor bias1, Tensor weight2, Tensor scale2, "
            "Tensor bias2, float eps, float negative_slope) -> Tensor")
_LIB.impl("s2d_tail", _cuda_forward, "CUDA")
_LIB.impl("s2d_tail", lambda *args: _torch_tail(*args).contiguous(), "CPU")


@torch.library.register_fake(f"{_build.OPS_NAMESPACE}::s2d_tail", lib=_LIB)
def _fake_op(x, scale1, bias1, weight2, scale2, bias2, eps, negative_slope):
    return x.new_empty(x.shape)


def fused_s2d_tail(
    x: torch.Tensor,
    scale1: torch.Tensor,
    bias1: torch.Tensor,
    weight2: torch.Tensor,
    scale2: torch.Tensor,
    bias2: torch.Tensor,
    eps: float = 1e-5,
    negative_slope: float = 0.01,
) -> torch.Tensor:
    """``lrelu(IN2(conv_s2d(lrelu(IN1(x)), K2)))`` of a q-major s2d tensor.

    ``x``: (B, H′, W′, 4C), conv_0's raw output. ``scale*``/``bias*``: the
    two norms' (C,) affines. ``weight2``: conv_1's canonical (C, C, 3, 3)
    kernel; its bias is not taken (it cancels in IN2).
    """
    if x.ndim != 4:
        raise ValueError(f"fused_s2d_tail takes (B, H', W', 4C), got {tuple(x.shape)}")
    tensors = (x, scale1, bias1, weight2, scale2, bias2)
    on_card = _build.uses_kernel(*tensors)  # raises on another device, or a mix
    if _build.records_grad(*tensors):
        if on_card:
            _build.refuse_grad("fused_s2d_tail", *tensors)
        # On the CPU, autograd of the plain ops (the operator records none).
        return _torch_tail(*tensors, eps, negative_slope)
    return torch.ops.unet_torch.s2d_tail(*tensors, eps, negative_slope)


# Kernel launches since the count was last set to 0 (CPU calls do not count).
fused_s2d_tail.launches = 0
