"""UNet building blocks as ``nn.Module``s, dense path.

Counterpart of ``unet_implementations_tpu/models/blocks.py``. Activations
are NCHW tensors in ``channels_last`` memory, so the kernels see NHWC-
contiguous memory through a ``permute`` view and cuDNN convs take the same
tensors without a copy.

Module attributes follow the reference torch UNet's state-dict scheme
(``block.{idx}`` inside a ``ConvBlock``, ``conv_block`` inside an
``UpBlock``): each conv owns the indices [Conv2d, InstanceNorm,
LeakyReLU(, channel dropout)], so a reference ``.pth`` loads strictly.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from unet_implementations_tpu_torch.kernels.instance_norm import fused_instance_norm
from unet_implementations_tpu_torch.kernels.upsample import upsample2x_nhwc_fast
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
    """

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(channels, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nchw(fused_instance_norm(nhwc(x), self.weight, self.bias, EPS, NEGATIVE_SLOPE))


class FusedActivation(nn.Identity):
    """The LeakyReLU slot of the reference ``block`` Sequential. The
    activation runs inside the preceding ``InstanceNorm`` (K1); this slot
    keeps the reference's state-dict indices."""


class ConvBlock(nn.Module):
    """2 x [3x3 Conv -> InstanceNorm+LeakyReLU -> channel dropout]; the
    stride applies to the first conv only."""

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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


class UpBlock(nn.Module):
    """Bilinear upsample to the skip's size, concat [upsampled, skip], ConvBlock.

    An exact 2x step goes through the K2 kernel; any other size ratio (odd
    input sizes) through ``resize_bilinear``.
    """

    def __init__(self, cin: int, skip_channels: int, features: int, dropout_rate: float = 0.0,
                 dtype=torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv_block = ConvBlock(cin + skip_channels, features, 1, dropout_rate, dtype,
                                    generator)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        size, skip_size = tuple(x.shape[2:]), tuple(skip.shape[2:])
        if size != skip_size:
            if skip_size == (2 * size[0], 2 * size[1]):
                x = nchw(upsample2x_nhwc_fast(nhwc(x)))
            else:
                x = nchw(resize_bilinear(nhwc(x), skip_size))
        x = torch.cat([x, skip], dim=1).contiguous(memory_format=torch.channels_last)
        return self.conv_block(x)
