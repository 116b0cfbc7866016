"""UNet building blocks as ``nn.Module``s, dense and space-to-depth.

Counterpart of ``unet_implementations_tpu/models/blocks.py``. Activations
are NCHW tensors in ``channels_last`` memory, so the kernels see NHWC-
contiguous memory through a ``permute`` view and cuDNN convs take the same
tensors without a copy. A space-to-depth (s2d) activation is the NCHW view
(B, 4C, H′, W′) of a q-major NHWC tensor (``models/s2d.py``).

Where JAX sets a block's layout as a module field, these blocks take it as a
``forward`` argument (``s2d``, ``s2d_input_first``, ``s2d_segments_first``),
since the UNet decides it from the input's size at each call. The layout
changes no parameter: each ``nn.Conv2d.weight`` is the canonical kernel, and
the s2d convs transform it at call time.

Module attributes follow the reference torch UNet's state-dict scheme
(``block.{idx}`` inside a ``ConvBlock``, ``conv_block`` inside an
``UpBlock``): each conv owns the indices [Conv2d, InstanceNorm,
LeakyReLU(, channel dropout)], so a reference ``.pth`` loads strictly.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from unet_implementations_tpu_torch.kernels.instance_norm import fused_instance_norm
from unet_implementations_tpu_torch.kernels.s2d_region import fused_s2d_tail
from unet_implementations_tpu_torch.kernels.upsample import (
    upsample2x_into_s2d_fast,
    upsample2x_nhwc_fast,
)
from unet_implementations_tpu_torch.models.s2d import (
    conv_s2d,
    conv_s2d_multi,
    conv_s2d_to_dense_stride2,
)
from unet_implementations_tpu_torch.ops.resize import resize_bilinear


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW (channels_last) -> NHWC view; contiguous without a copy."""
    return x.permute(0, 2, 3, 1)


def nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW view, channels_last in memory."""
    return x.permute(0, 3, 1, 2)


def kaiming_conv(cin: int, cout: int, kernel_size: int, stride: int, dtype,
                 generator: Optional[torch.Generator]) -> nn.Conv2d:
    """Conv2d with the reference init: Kaiming-normal fan_out with gain²=2
    (std = sqrt(2 / (k*k*cout))), zero bias; padding k//2."""
    conv = nn.Conv2d(cin, cout, kernel_size, stride, kernel_size // 2)
    with torch.no_grad():
        std = math.sqrt(2.0 / (kernel_size * kernel_size * cout))
        conv.weight.normal_(0.0, std, generator=generator)
        conv.bias.zero_()
    return conv.to(dtype=dtype, memory_format=torch.channels_last)


# The reference block: InstanceNorm2d(eps=1e-5, affine) + LeakyReLU(0.01)
# after every 3x3 conv, two convs per block.
EPS = 1e-5
NEGATIVE_SLOPE = 0.01
N_CONVS = 2


class InstanceNorm(nn.Module):
    """Per-image, per-channel InstanceNorm (biased variance, float32
    statistics) fused with LeakyReLU: the K1 kernel. Its affine ``weight``
    (scale) and ``bias`` stay float32 whatever the activation dtype.

    In bf16 the JAX model's default path rounds the norm to bf16 and then
    applies LeakyReLU in bf16; K1 applies it in float32 and rounds once, so
    a negative output can differ from the JAX bf16 model by one bf16 ulp.

    ``group=4`` takes an s2d tensor: each original channel's statistics pool
    its 4 q-major sub-pixel blocks.
    """

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(channels, dtype=torch.float32))

    def forward(self, x: torch.Tensor, group: int = 1) -> torch.Tensor:
        return nchw(fused_instance_norm(nhwc(x), self.weight, self.bias, EPS, NEGATIVE_SLOPE,
                                        group))


class FusedActivation(nn.Identity):
    """The LeakyReLU slot of the reference ``block`` Sequential. The
    activation runs inside the preceding ``InstanceNorm`` (K1); this slot
    keeps the reference's state-dict indices."""


class ConvBlock(nn.Module):
    """2 x [3x3 Conv -> InstanceNorm+LeakyReLU -> channel dropout]; the
    stride applies to the first conv only.

    Layouts (``forward`` arguments):
    - dense (default): ``x`` is a dense tensor, the block runs as the
      reference's ``block`` Sequential;
    - ``s2d``: ``x`` is an s2d tensor, or with ``s2d_segments_first`` a tuple
      of s2d tensors whose logical channel-concat conv_0 takes without
      materializing it (segments: their dense channel counts); the output is
      s2d. In eval mode conv_0 is followed by the fused tail (K3);
    - ``s2d_input_first``: conv_0 is the stride-2 conv taking an s2d tensor,
      with a dense half-resolution output; the rest of the block is dense.
    """

    def __init__(self, cin: int, features: int, stride: int = 1, dropout_rate: float = 0.0,
                 dtype=torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        layers = []
        c = cin
        for i in range(N_CONVS):
            layers += [
                kaiming_conv(c, features, 3, stride if i == 0 else 1, dtype, generator),
                InstanceNorm(features),
                FusedActivation(),
            ]
            if dropout_rate > 0:
                layers.append(nn.Dropout2d(dropout_rate))
            c = features
        self.block = nn.Sequential(*layers)
        self.dropout_rate = dropout_rate
        self.step = 4 if dropout_rate > 0 else 3

    def _unit(self, i: int):
        """(conv, norm) of conv unit i."""
        return self.block[i * self.step], self.block[i * self.step + 1]

    def _conv0(self, x, s2d_input_first: bool,
               segments: Optional[Tuple[int, ...]]) -> torch.Tensor:
        conv = self._unit(0)[0]
        if s2d_input_first:
            return nchw(conv_s2d_to_dense_stride2(nhwc(x), conv.weight, conv.bias))
        if segments is not None:
            return nchw(conv_s2d_multi([nhwc(xi) for xi in x], conv.weight, conv.bias,
                                       segments))
        return nchw(conv_s2d(nhwc(x), conv.weight, conv.bias))

    def _dropout_s2d(self, x: torch.Tensor) -> torch.Tensor:
        """Channel dropout of an s2d tensor: whole original channels drop, the
        mask broadcast over space and the 4 q blocks."""
        if not self.training or self.dropout_rate == 0:
            return x
        xh = nhwc(x)
        b, hp, wp, c4 = xh.shape
        keep = torch.nn.functional.dropout(xh.new_ones((b, 1, 1, 1, c4 // 4)),
                                           self.dropout_rate, training=True)
        return nchw((xh.reshape(b, hp, wp, 4, c4 // 4) * keep).reshape(b, hp, wp, c4))

    def forward(self, x, s2d: bool = False, s2d_input_first: bool = False,
                s2d_segments_first: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
        if not (s2d or s2d_input_first):
            return self.block(x)
        if s2d and s2d_input_first:
            raise ValueError("a block is s2d or takes an s2d input first, not both")
        x = self._conv0(x, s2d_input_first, s2d_segments_first)
        if s2d and N_CONVS == 2 and not self.training:
            # The fused tail (K3): IN -> lrelu -> conv_1 -> IN -> lrelu.
            # Dropout is off in eval mode; conv_1's bias cancels in IN2.
            (_, norm0), (conv1, norm1) = self._unit(0), self._unit(1)
            return nchw(fused_s2d_tail(nhwc(x), norm0.weight, norm0.bias, conv1.weight,
                                       norm1.weight, norm1.bias, EPS, NEGATIVE_SLOPE))
        for i in range(N_CONVS):
            conv, norm = self._unit(i)
            if i > 0:
                x = nchw(conv_s2d(nhwc(x), conv.weight, conv.bias)) if s2d else conv(x)
            if s2d:
                x = self._dropout_s2d(norm(x, group=4))
            else:
                x = norm(x)
                if self.dropout_rate > 0:
                    x = self.block[i * self.step + 3](x)
        return x


class UpBlock(nn.Module):
    """Bilinear upsample to the skip's size, concat [upsampled, skip], ConvBlock.

    Dense: an exact 2x step goes through the K2a kernel, any other size ratio
    (odd input sizes) through ``resize_bilinear``, and the concat is
    materialized. ``s2d``: ``skip`` is an s2d tensor at ``x``'s spatial size;
    K2b emits the upsample straight into s2d layout, and the two s2d tensors
    go to the block as segments, never concatenated.
    """

    def __init__(self, cin: int, skip_channels: int, features: int, dropout_rate: float = 0.0,
                 dtype=torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv_block = ConvBlock(cin + skip_channels, features, 1, dropout_rate, dtype,
                                    generator)

    def forward(self, x: torch.Tensor, skip: torch.Tensor, s2d: bool = False) -> torch.Tensor:
        size, skip_size = tuple(x.shape[2:]), tuple(skip.shape[2:])
        if s2d:
            if size != skip_size:
                raise ValueError(f"an s2d skip must match x spatially: {size} vs {skip_size}")
            up = nchw(upsample2x_into_s2d_fast(nhwc(x)))
            segments = (x.shape[1], skip.shape[1] // 4)
            return self.conv_block((up, skip), s2d=True, s2d_segments_first=segments)
        if size != skip_size:
            if skip_size == (2 * size[0], 2 * size[1]):
                x = nchw(upsample2x_nhwc_fast(nhwc(x)))
            else:
                x = nchw(resize_bilinear(nhwc(x), skip_size))
        x = torch.cat([x, skip], dim=1).contiguous(memory_format=torch.channels_last)
        return self.conv_block(x)
