"""K2: exact 2x bilinear upsample, forward (CUDA, ``csrc/upsample.cu``).

Two wrappers of one kernel, in two output layouts:

- ``upsample2x_nhwc_fast`` (K2a) replaces ``unet_implementations_tpu/
  kernels/upsample.py::_upsample2x_dense_pallas`` (``_dense_kernel``):
  (B, H, W, C) -> (B, 2H, 2W, C). It heads every dense decoder whose skip is
  exactly twice its input: 5 calls per forward of the dense 6-stage model
  at 512², 3 of the space-to-depth one.
- ``upsample2x_into_s2d_fast`` (K2b) replaces ``_upsample2x_s2d_pallas``
  (``_s2d_kernel``): (B, H, W, C) -> (B, H, W, 4C), the four sub-pixel
  phases as q-major channel blocks, i.e. the space-to-depth of the
  upsample. It heads the two s2d decoders of the s2d 6-stage model.

Torch half-pixel sampling, edge-clamped; bitwise equal to the plain
versions ``ops.resize.upsample2x_nhwc`` and ``ops.s2d.
upsample2x_into_s2d`` (float32 lerp along H, round, lerp along W, round).

Bound: bytes — one read of x and one write of the 4x larger output. Each
thread writes the four sub-pixel phases of one input pixel straight to their
places in the output; see the source. No single PyTorch call writes the
q-major layout (``F.pixel_unshuffle`` is c-major, channel c·4 + q).

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches the kernel or raises. Both are operators, ``torch.ops.unet_torch.
upsample2x`` and ``upsample2x_s2d`` (CUDA: the launch, counted there; CPU:
the plain version; fake tensors: the output shape), so ``torch.export``
captures each call as one node; a call that autograd records goes through
``_Upsample2x``, whose backward is the transpose below.

Under spatial partitioning (``parallel/spatial.py``) a rank holds a row shard
of each image. ``upsample2x_nhwc_halo`` runs K2a unchanged on the shard with
one halo row on each side (the neighbours' edge rows, or the shard's own
edge row repeated at the image's top and bottom, which is the kernel's edge
clamp) and keeps output rows [2, 2h + 2): each is computed from the same
input values as the unsharded kernel's row, so it is that row bit for bit.

Both are differentiable. The backward is the transpose of the plain version,
as the JAX package's is (``jax.linear_transpose`` of the reference,
upsample.py:211-216), with JAX's roundings: per axis, in the reverse order of
the forward, the two lerps are transposed in float32 (each input element
gathers 0.75 of its two sub-pixels and 0.25 of the neighbours', edges
clamped), with the casts and additions in the input's dtype where the
forward's slices were cast (``_lerp2_taps_transpose``). JAX has no backward
kernel here, so there is none: it is plain torch ops on both devices.
"""

from __future__ import annotations

import ctypes
import math

import torch

from unet_implementations_tpu_torch.kernels import _build
from unet_implementations_tpu_torch.ops.s2d import upsample2x_into_s2d
from unet_implementations_tpu_torch.ops.resize import upsample2x_nhwc

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _cuda_forward(x: torch.Tensor, s2d: bool) -> torch.Tensor:
    """The launch (counted in its wrapper's ``launches``), on a CUDA tensor."""
    name = "upsample2x_into_s2d_fast" if s2d else "upsample2x_nhwc_fast"
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {x.dtype}")
    b, h, w, c = x.shape
    x = x.contiguous()
    shape = (b, h, w, 4 * c) if s2d else (b, 2 * h, 2 * w, c)
    y = torch.empty(shape, dtype=x.dtype, device=x.device)
    entry = "unet_upsample2x_s2d_fwd" if s2d else "unet_upsample2x_fwd"
    fn = _build.kernel_function(entry, _ARGTYPES)
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), y.data_ptr(), _build.DTYPE_CODES[x.dtype], b, h, w, c,
                  _build.stream_of(x))
    _build.check(code, entry)
    (upsample2x_into_s2d_fast if s2d else upsample2x_nhwc_fast).launches += 1
    return y


def _lerp2_taps_transpose(ct_even: torch.Tensor, ct_odd: torch.Tensor, axis: int,
                          dtype: torch.dtype) -> torch.Tensor:
    """Transpose of ``ops.resize.lerp2_taps`` along ``axis``: the cotangents of
    its (even, odd) outputs -> the cotangent of its input, in ``dtype``.

    even[i] = 0.25·x[i−1] + 0.75·x[i], odd[i] = 0.75·x[i] + 0.25·x[i+1], with
    x[−1] = x[0] and x[n] = x[n−1], in float32 from the edge-padded input's
    three slices, each cast to float32. So, as JAX transposes it: each
    slice's cotangent is formed in float32 and cast to ``dtype``, and the
    three are summed in ``dtype`` into the padded input (mid + right, then
    left), whose edge entries then fold into x[n−1] and x[0]."""
    e, o = ct_even.to(torch.float32), ct_odd.to(torch.float32)
    n = e.shape[axis]
    left = (0.25 * e).to(dtype)
    right = (0.25 * o).to(dtype)
    dx = (0.75 * e + 0.75 * o).to(dtype)
    if n > 1:
        dx.narrow(axis, 1, n - 1).add_(right.narrow(axis, 0, n - 1))
        dx.narrow(axis, 0, n - 1).add_(left.narrow(axis, 1, n - 1))
    dx.narrow(axis, n - 1, 1).add_(right.narrow(axis, n - 1, 1))
    dx.narrow(axis, 0, 1).add_(left.narrow(axis, 0, 1))
    return dx


def upsample2x_nhwc_transpose(ct: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Transpose of ``upsample2x_nhwc``: (B, 2H, 2W, C) -> (B, H, W, C) in
    ``dtype`` (the input's), W first, then H."""
    b, h2, w2, c = ct.shape
    ct = ct.reshape(b, h2, w2 // 2, 2, c)
    rows = _lerp2_taps_transpose(ct[:, :, :, 0], ct[:, :, :, 1], 2, dtype)
    rows = rows.reshape(b, h2 // 2, 2, w2 // 2, c)
    return _lerp2_taps_transpose(rows[:, :, 0], rows[:, :, 1], 1, dtype)


def upsample2x_into_s2d_transpose(ct: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Transpose of ``upsample2x_into_s2d``: (B, H, W, 4C) -> (B, H, W, C) in
    ``dtype``; the q-major blocks are the (row, column) phases 00, 01, 10, 11."""
    c00, c01, c10, c11 = ct.chunk(4, dim=-1)
    row0 = _lerp2_taps_transpose(c00, c01, 2, dtype)
    row1 = _lerp2_taps_transpose(c10, c11, 2, dtype)
    return _lerp2_taps_transpose(row0, row1, 1, dtype)


# The two layouts as operators (``torch.ops.unet_torch.upsample2x`` and
# ``upsample2x_s2d``): the launch on a CUDA tensor, the plain version on a CPU
# one, and the output shape under fake tensors, so that ``torch.export``
# captures each call as one node.
_LIB = _build.op_library()


def _register(name: str, s2d: bool, plain) -> None:
    def fake(x):
        b, h, w, c = x.shape
        return x.new_empty((b, h, w, 4 * c) if s2d else (b, 2 * h, 2 * w, c))

    _LIB.define(f"{name}(Tensor x) -> Tensor")
    _LIB.impl(name, lambda x: _cuda_forward(x, s2d), "CUDA")
    _LIB.impl(name, lambda x: plain(x).contiguous(), "CPU")
    torch.library.register_fake(f"{_build.OPS_NAMESPACE}::{name}", fake, lib=_LIB)


_register("upsample2x", False, upsample2x_nhwc)
_register("upsample2x_s2d", True, upsample2x_into_s2d)


def _op(x: torch.Tensor, s2d: bool) -> torch.Tensor:
    return torch.ops.unet_torch.upsample2x_s2d(x) if s2d else torch.ops.unet_torch.upsample2x(x)


class _Upsample2x(torch.autograd.Function):
    """A call that autograd records: the operator forward, the plain
    transpose backward."""

    @staticmethod
    def forward(ctx, x, s2d):
        ctx.s2d, ctx.dtype = s2d, x.dtype
        return _op(x, s2d)

    @staticmethod
    def backward(ctx, ct):
        transpose = upsample2x_into_s2d_transpose if ctx.s2d else upsample2x_nhwc_transpose
        return transpose(ct, ctx.dtype), None


def _upsample(x: torch.Tensor, s2d: bool) -> torch.Tensor:
    _build.uses_kernel(x)  # raises on a device other than the CPU or CUDA
    return _Upsample2x.apply(x, s2d) if _build.records_grad(x) else _op(x, s2d)


def upsample_bytes(shape, itemsize: int) -> int:
    """The least bytes of one call of either wrapper: x read once and the 4x
    larger output written once (its roofline bound, ``chip_smoke.py`` and
    ``utils/profiling.py``)."""
    return 5 * math.prod(shape) * itemsize


def upsample_operations(shape) -> int:
    """Float32 operations of one call: 2 H-lerps and 4 W-lerps of 3
    operations per input element (the shared halo lerps counted once)."""
    return 18 * math.prod(shape)


def _check_input(x: torch.Tensor, name: str) -> None:
    if x.ndim != 4 or min(x.shape) == 0:
        raise ValueError(f"{name} takes a non-empty (B, H, W, C), got {tuple(x.shape)}")


def upsample2x_nhwc_fast(x: torch.Tensor) -> torch.Tensor:
    """Exact 2x bilinear upsample of an NHWC tensor: (B,H,W,C) -> (B,2H,2W,C)."""
    _check_input(x, "upsample2x_nhwc_fast")
    return _upsample(x, False)


def upsample2x_into_s2d_fast(x: torch.Tensor) -> torch.Tensor:
    """Exact 2x bilinear upsample emitted in s2d layout: (B,H,W,C) -> (B,H,W,4C),
    q-major (channel q·C + c, q = dy·2 + dx)."""
    _check_input(x, "upsample2x_into_s2d_fast")
    return _upsample(x, True)


def upsample2x_nhwc_halo(x: torch.Tensor, above: torch.Tensor,
                         below: torch.Tensor) -> torch.Tensor:
    """``upsample2x_nhwc_fast`` of a row shard (B, h, W, C) of images, given
    the rows beyond it, ``above`` and ``below`` (B, 1, W, C): (B, 2h, 2W, C),
    the shard's rows of the upsampled images. K2a (one launch) on the h + 2
    rows, cropped to output rows [2, 2h + 2)."""
    _check_input(x, "upsample2x_nhwc_halo")
    h = x.shape[1]
    up = upsample2x_nhwc_fast(torch.cat([above, x, below], dim=1))
    return up[:, 2:2 * h + 2]


# Kernel launches since the count was last set to 0 (CPU calls do not count).
upsample2x_nhwc_fast.launches = 0
upsample2x_into_s2d_fast.launches = 0
