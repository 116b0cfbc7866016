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
versions ``ops.resize.upsample2x_nhwc`` and ``models.s2d.
upsample2x_into_s2d`` (float32 lerp along H, round, lerp along W, round).

Bound: bytes — one read of x and one write of the 4x larger output. Each
thread writes the four sub-pixel phases of one input pixel straight to their
places in the output; see the source. No single PyTorch call writes the
q-major layout (``F.pixel_unshuffle`` is c-major, channel c·4 + q).

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches the kernel or raises. Forward only: a CUDA call that autograd would
record raises.
"""

from __future__ import annotations

import ctypes

import torch

from unet_implementations_tpu_torch.kernels import _build
from unet_implementations_tpu_torch.models.s2d import upsample2x_into_s2d
from unet_implementations_tpu_torch.ops.resize import upsample2x_nhwc

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _cuda_forward(x: torch.Tensor, s2d: bool) -> torch.Tensor:
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
    return y


def _check_input(x: torch.Tensor, name: str) -> None:
    if x.ndim != 4 or min(x.shape) == 0:
        raise ValueError(f"{name} takes a non-empty (B, H, W, C), got {tuple(x.shape)}")


def upsample2x_nhwc_fast(x: torch.Tensor) -> torch.Tensor:
    """Exact 2x bilinear upsample of an NHWC tensor: (B,H,W,C) -> (B,2H,2W,C)."""
    _check_input(x, "upsample2x_nhwc_fast")
    if not _build.uses_kernel(x):
        return upsample2x_nhwc(x)
    _build.refuse_grad("upsample2x_nhwc_fast", x)
    y = _cuda_forward(x, s2d=False)
    upsample2x_nhwc_fast.launches += 1
    return y


def upsample2x_into_s2d_fast(x: torch.Tensor) -> torch.Tensor:
    """Exact 2x bilinear upsample emitted in s2d layout: (B,H,W,C) -> (B,H,W,4C),
    q-major (channel q·C + c, q = dy·2 + dx)."""
    _check_input(x, "upsample2x_into_s2d_fast")
    if not _build.uses_kernel(x):
        return upsample2x_into_s2d(x)
    _build.refuse_grad("upsample2x_into_s2d_fast", x)
    y = _cuda_forward(x, s2d=True)
    upsample2x_into_s2d_fast.launches += 1
    return y


# Kernel launches since the count was last set to 0 (CPU calls do not count).
upsample2x_nhwc_fast.launches = 0
upsample2x_into_s2d_fast.launches = 0
