"""Resize primitives with torch/cv2 semantics, NHWC.

Counterpart of ``unet_implementations_tpu/ops/resize.py``. Nearest uses
the source index ``floor(dst * in/out)``. Bilinear uses
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


def _nearest_indices(out_size: int, in_size: int, device=None) -> torch.Tensor:
    """Source index of each output position, ``floor(dst * in/out)`` computed
    in float64 on the host (as torch and JAX do), clipped to the input."""
    idx = np.floor(np.arange(out_size, dtype=np.float64) * (in_size / out_size)).astype(np.int64)
    return torch.from_numpy(np.clip(idx, 0, in_size - 1)).to(device)


def resize_nearest(x: torch.Tensor, size: Tuple[int, int],
                   spatial_axes: Tuple[int, int] = (-2, -1)) -> torch.Tensor:
    """Nearest-neighbour resize along two axes (default the last two: masks;
    ``(1, 2)`` for NHWC images), the asymmetric ``floor(dst * in/out)``
    mapping of ``F.interpolate(mode="nearest")`` and cv2's ``INTER_NEAREST``.
    Any dtype; the values are gathered, not computed."""
    ax_h, ax_w = (a % x.ndim for a in spatial_axes)
    x = torch.index_select(x, ax_h, _nearest_indices(size[0], x.shape[ax_h], x.device))
    return torch.index_select(x, ax_w, _nearest_indices(size[1], x.shape[ax_w], x.device))


def _linear_weights(out_size: int, in_size: int, device=None):
    """The two source indices and the second one's weight of each output
    position, in float32, made on ``device`` (no copy from the host, which on
    a card would wait for its queue)."""
    scale = float(np.float32(in_size / out_size))
    src = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * scale - 0.5
    src = torch.clamp_min(src, 0.0)
    i0 = torch.clamp(torch.floor(src).to(torch.int64), 0, in_size - 1)
    i1 = torch.clamp(i0 + 1, 0, in_size - 1)
    w1 = src - i0.to(torch.float32)
    return i0, i1, w1


def _interp_axis(x: torch.Tensor, axis: int, out_size: int) -> torch.Tensor:
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    i0, i1, w1 = _linear_weights(out_size, in_size, x.device)
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
