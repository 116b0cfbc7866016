"""K2: exact 2x bilinear upsample, dense NHWC, forward (CUDA, ``csrc/upsample.cu``).

Replaces ``unet_implementations_tpu/kernels/upsample.py::
_upsample2x_dense_pallas`` (``_dense_kernel``). It heads every decoder of the
UNet whose skip is exactly twice its input: 5 calls per forward of the
6-stage model at 512².

Torch half-pixel sampling, edge-clamped; bitwise equal to the plain version
``ops.resize.upsample2x_nhwc`` (float32 lerp along H, round, lerp along W,
round).

Bound: bytes — one read of x and one write of the 4x larger output. Each
thread writes the four sub-pixel phases of one input pixel straight into the
interleaved output; see the source.

On a CPU tensor ``upsample2x_nhwc_fast`` runs the plain version; on a CUDA
tensor it launches the kernel or raises. Forward only: a CUDA call that
autograd would record raises.
"""

from __future__ import annotations

import ctypes

import torch

from unet_implementations_tpu_torch.kernels import _build
from unet_implementations_tpu_torch.ops.resize import upsample2x_nhwc

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _cuda_forward(x: torch.Tensor) -> torch.Tensor:
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"upsample2x_nhwc_fast takes float32 or bfloat16, got {x.dtype}")
    b, h, w, c = x.shape
    x = x.contiguous()
    y = torch.empty((b, 2 * h, 2 * w, c), dtype=x.dtype, device=x.device)
    fn = _build.kernel_function("unet_upsample2x_fwd", _ARGTYPES)
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), y.data_ptr(), _build.DTYPE_CODES[x.dtype], b, h, w, c,
                  _build.stream_of(x))
    _build.check(code, "unet_upsample2x_fwd")
    upsample2x_nhwc_fast.launches += 1
    return y


def upsample2x_nhwc_fast(x: torch.Tensor) -> torch.Tensor:
    """Exact 2x bilinear upsample of an NHWC tensor: (B,H,W,C) -> (B,2H,2W,C)."""
    if x.ndim != 4 or min(x.shape) == 0:
        raise ValueError(f"upsample2x_nhwc_fast takes a non-empty (B, H, W, C), got {tuple(x.shape)}")
    if not _build.uses_kernel(x):
        return upsample2x_nhwc(x)
    _build.refuse_grad("upsample2x_nhwc_fast", x)
    return _cuda_forward(x)


# Kernel launches since the count was last set to 0 (CPU calls do not count).
upsample2x_nhwc_fast.launches = 0
