"""Resize primitives with torch/cv2 semantics, NHWC.

Counterpart of ``unet_implementations_tpu/ops/resize.py``. Bilinear uses
half-pixel centers with edge clamping (``F.interpolate(mode="bilinear",
align_corners=False)``); the source coordinates are computed in float32 as
torch's own kernels do.

``lerp2_taps`` and ``upsample2x_nhwc`` are the plain version of the exact 2x
upsample kernel (``kernels/upsample.py``), which must match them bitwise: the
lerps accumulate in float32 and round back to the input dtype after each
axis, H first.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _linear_weights(out_size: int, in_size: int):
    scale = np.float32(in_size / out_size)
    src = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * scale - np.float32(0.5)
    src = np.maximum(src, 0.0)
    i0 = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    i1 = np.clip(i0 + 1, 0, in_size - 1)
    w1 = (src - i0.astype(np.float32)).astype(np.float32)
    return i0, i1, w1


def _interp_axis(x: torch.Tensor, axis: int, out_size: int) -> torch.Tensor:
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    i0, i1, w1 = (torch.from_numpy(a).to(x.device) for a in _linear_weights(out_size, in_size))
    x0 = torch.index_select(x, axis, i0)
    x1 = torch.index_select(x, axis, i1)
    shape = [1] * x.ndim
    shape[axis] = out_size
    w1 = w1.reshape(shape).to(x0.dtype)
    return x0 * (1 - w1) + x1 * w1


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of an NHWC tensor to ``size`` = (H, W), in float32."""
    orig_dtype = x.dtype
    x = x.to(torch.float32)
    x = _interp_axis(x, 1, size[0])
    x = _interp_axis(x, 2, size[1])
    return x.to(orig_dtype)


def lerp2_taps(x: torch.Tensor, axis: int) -> tuple:
    """The two sub-pixel lerps of an exact 2x bilinear upsample along one
    axis: even = 0.25*x[i-1] + 0.75*x[i], odd = 0.75*x[i] + 0.25*x[i+1]
    (edge-clamped), in float32, rounded back to the input dtype."""
    n = x.shape[axis]
    xp = torch.cat([x.narrow(axis, 0, 1), x, x.narrow(axis, n - 1, 1)], dim=axis)
    left, mid, right = (xp.narrow(axis, start, n).to(torch.float32) for start in (0, 1, 2))
    even = (0.25 * left + 0.75 * mid).to(x.dtype)
    odd = (0.75 * mid + 0.25 * right).to(x.dtype)
    return even, odd


def _upsample2x_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
    even, odd = lerp2_taps(x, axis)
    shape = list(x.shape)
    shape[axis] = 2 * x.shape[axis]
    return torch.stack([even, odd], dim=axis + 1).reshape(shape)


def upsample2x_nhwc(x: torch.Tensor) -> torch.Tensor:
    """Exact 2x bilinear upsample of an NHWC tensor: (B,H,W,C) -> (B,2H,2W,C)."""
    return _upsample2x_axis(_upsample2x_axis(x, 1), 2)
