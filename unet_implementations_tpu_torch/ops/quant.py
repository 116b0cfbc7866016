"""The opt-in fp8 conv mode: every conv of the model through ``qconv``.

Counterpart of ``unet_implementations_tpu/ops/quant.py``, with its
environment variables and parsing:

- ``UNET_TPU_CONV_FP8``: unset, empty, ``off``, ``false`` or ``none`` (the
  default): no conv is quantized. ``all`` (or ``0``): every conv. An integer
  N: the convs whose input grid, ``min(H, W)``, is at least N. Anything else:
  off.
- ``UNET_TPU_CONV_FP8_DTYPE``: ``e5m2`` (the default) or ``e4m3``
  (``fp8_e4m3``, ``float8_e4m3fn``).

The policy is read at each call, since the port runs eagerly; under
``torch.export`` it is read while tracing, as JAX reads it at trace time. A
conv it takes casts the activation (bf16 or fp16) and the weight, already
cast to the activation's dtype, to fp8, sums in float32, rounds to the
activation's dtype, and only then adds the bias in that dtype: the kernel of
``kernels/fp8_conv.py`` on the card, its plain version on the CPU. The
parameters stay float32 and the state dict is unchanged. Any other conv is
exactly the ``F.conv2d`` call the model makes without the mode.

The mode is forward-only in the port: a quantized conv that autograd would
record raises ``NotImplementedError``. JAX differentiates through its casts,
but calls the mode serving-only and its transposes unvalidated
(ROADMAP.md's departures).

Activations are NCHW views (channels_last memory), so the grid is
``x.shape[2:]``. A row shard (``parallel/spatial.py``) passes ``rows``, the
whole image's rows, as JAX's sharded program sees the global array.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from unet_implementations_tpu_torch.kernels import _build
from unet_implementations_tpu_torch.kernels.fp8_conv import fp8_conv

__all__ = ["fp8_conv_min_grid", "fp8_conv_dtype", "quantizes", "qconv", "qconv_sum"]


def fp8_conv_min_grid() -> Optional[int]:
    """The least input-grid edge of a quantized conv, or None (off), from
    ``UNET_TPU_CONV_FP8``."""
    v = os.environ.get("UNET_TPU_CONV_FP8", "").strip().lower()
    if v in ("", "off", "false", "none"):
        return None
    if v == "all":
        return 0
    try:
        return int(v)
    except ValueError:
        return None


def fp8_conv_dtype() -> torch.dtype:
    """The fp8 dtype of the conv operands (``UNET_TPU_CONV_FP8_DTYPE``)."""
    v = os.environ.get("UNET_TPU_CONV_FP8_DTYPE", "e5m2").strip().lower()
    if v in ("e4m3", "fp8_e4m3", "float8_e4m3fn"):
        return torch.float8_e4m3fn
    return torch.float8_e5m2


def quantizes(x: torch.Tensor, rows: Optional[int] = None) -> bool:
    """Whether the policy quantizes a conv of the NCHW activation ``x``: the
    mode is on, x is a floating dtype of at most 2 bytes, and its grid (with
    ``rows`` in place of H on a row shard) is at least the policy's."""
    min_grid = fp8_conv_min_grid()
    if min_grid is None or not x.dtype.is_floating_point or x.element_size() > 2:
        return False
    h = x.shape[2] if rows is None else rows
    return min(h, x.shape[3]) >= min_grid


def _paddings(padding) -> tuple:
    """int | (top, bottom, left, right) -> (top, bottom, left, right)."""
    return (padding,) * 4 if isinstance(padding, int) else tuple(padding)


def _conv2d(x, weight, bias, stride: int, pads: tuple) -> torch.Tensor:
    """F.conv2d with (top, bottom, left, right) padding, bottom <= top and
    right <= left: padded by top and left on both sides, the extra output rows
    and columns dropped (a view)."""
    t, b, le, r = pads
    if b > t or r > le:
        raise ValueError(f"padding {pads}: the bottom and right may not exceed the top and left")
    y = F.conv2d(x, weight, bias, stride, (t, le))
    if (b, r) == (t, le):
        return y
    kh, kw = weight.shape[2:]
    ho = (x.shape[2] + t + b - kh) // stride + 1
    wo = (x.shape[3] + le + r - kw) // stride + 1
    return y[:, :, :ho, :wo]


def qconv_sum(xs: Sequence[torch.Tensor], weights: Sequence[torch.Tensor],
              bias: Optional[torch.Tensor], stride: int = 1, padding=0,
              rows: Optional[int] = None,
              residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``Σ_i conv(xs[i], weights[i]) + bias``: the conv of the channel-concat
    of the NCHW tensors ``xs`` by the kernel whose input-channel slices are
    ``weights`` (each in the activations' dtype), without the concat.
    ``padding``: an int or (top, bottom, left, right).

    Quantized (``quantizes``): the terms in the activations' dtype, summed in
    order, then the bias, as JAX's ``ConvOp`` and ``conv_s2d_multi`` do.
    Otherwise the bias goes with the first conv and the others add into its
    output in place.

    ``residual`` (NCHW, the output's shape): a folded segment's contribution
    (JAX's up-folds). Quantized, it comes first, as in JAX: the convs add to
    it in order, then the bias. Otherwise it adds into the convs' sum in
    place, last."""
    pads = _paddings(padding)
    if quantizes(xs[0], rows):
        tensors = [*xs, *weights] + ([] if bias is None else [bias])
        tensors += [] if residual is None else [residual]
        if _build.records_grad(*tensors):
            raise NotImplementedError(
                "the fp8 conv mode (UNET_TPU_CONV_FP8) is forward-only in the PyTorch package: "
                "run it under torch.no_grad() or torch.inference_mode(), or unset the variable "
                "to train (ROADMAP.md's departures)")
        fp8 = fp8_conv_dtype()
        y = None if residual is None else residual.permute(0, 2, 3, 1)
        for i, (x, w) in enumerate(zip(xs, weights)):
            last = i == len(xs) - 1
            y = fp8_conv(x.permute(0, 2, 3, 1), w, bias if last else None, y, stride, pads, fp8)
        return y.permute(0, 3, 1, 2)
    y = None
    for x, w in zip(xs, weights):
        yi = _conv2d(x, w, bias if y is None else None, stride, pads)
        y = yi if y is None else y.add_(yi)
    return y if residual is None else y.add_(residual)


def qconv(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
          stride: int = 1, padding=0, rows: Optional[int] = None) -> torch.Tensor:
    """``F.conv2d`` of the NCHW ``x`` with the fp8 policy applied (see
    ``qconv_sum``, of one term)."""
    return qconv_sum((x,), (weight,), bias, stride, padding, rows)
