"""UNet building blocks as ``nn.Module``s, dense and space-to-depth.

Counterpart of ``unet_implementations_tpu/models/blocks.py``. Activations
are NCHW tensors in ``channels_last`` memory, so the kernels see NHWC-
contiguous memory through a ``permute`` view and cuDNN convs take the same
tensors without a copy. A space-to-depth (s2d) activation is the NCHW view
(B, 4C, H′, W′) of a q-major NHWC tensor (``ops/s2d.py``).

Where JAX sets a block's layout as a module field, these blocks take it as a
``forward`` argument (``s2d``, ``s2d_input_first``, ``s2d_segments_first``),
since the UNet decides it from the input's size at each call. The layout
changes no parameter: each ``nn.Conv2d.weight`` is the canonical kernel, and
the s2d convs transform it at call time.

Parameters are float32, as the JAX model's (flax's default ``param_dtype``);
every conv casts its weight and bias to the activation's dtype at the call,
as the JAX ``ConvOp`` does, so a bf16 model trains float32 masters. Channel
dropout draws from the ``torch.Generator`` passed down from ``UNet.forward``.

Under spatial partitioning ``UNet.forward`` also passes down a
``parallel/spatial.py::SpatialContext``: the dense blocks then run on a row
shard of each image. A 3×3 conv pads the shard with its neighbours' edge rows
(``pad_rows``), K1 normalizes with the whole images' statistics, and K2a
upsamples the shard with one halo row a side (``upsample2x_nhwc_halo``).
Channel dropout is per (image, channel), so the ranks of a space group, whose
generators draw alike, drop the same channels.

Module attributes follow the reference torch UNet's state-dict scheme
(``block.{idx}`` inside a ``ConvBlock``, ``conv_block`` inside an
``UpBlock``): each conv owns the indices [Conv2d, InstanceNorm,
LeakyReLU(, channel dropout)], so a reference ``.pth`` loads strictly.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from unet_implementations_tpu_torch.kernels.instance_norm import fused_instance_norm
from unet_implementations_tpu_torch.kernels.s2d_region import fused_s2d_tail, region_applicable
from unet_implementations_tpu_torch.kernels.upsample import (
    upsample2x_into_s2d_fast,
    upsample2x_nhwc_fast,
    upsample2x_nhwc_halo,
)
from unet_implementations_tpu_torch.ops.s2d import (
    conv_s2d,
    conv_s2d_multi,
    conv_s2d_to_dense_stride2,
)
from unet_implementations_tpu_torch.ops.resize import resize_bilinear
from unet_implementations_tpu_torch.parallel.spatial import SpatialContext, halo_rows, pad_rows


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW (channels_last) -> NHWC view; contiguous without a copy."""
    return x.permute(0, 2, 3, 1)


def nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW view, channels_last in memory."""
    return x.permute(0, 3, 1, 2)


def kaiming_conv(cin: int, cout: int, kernel_size: int, stride: int,
                 generator: Optional[torch.Generator]) -> nn.Conv2d:
    """Float32 Conv2d with the reference init: Kaiming-normal fan_out with
    gain²=2 (std = sqrt(2 / (k*k*cout))), zero bias; padding k//2."""
    conv = nn.Conv2d(cin, cout, kernel_size, stride, kernel_size // 2)
    with torch.no_grad():
        std = math.sqrt(2.0 / (kernel_size * kernel_size * cout))
        conv.weight.normal_(0.0, std, generator=generator)
        conv.bias.zero_()
    return conv.to(memory_format=torch.channels_last)


def conv2d(x: torch.Tensor, conv: nn.Conv2d,
           spatial: Optional[SpatialContext] = None) -> torch.Tensor:
    """``conv`` applied in x's dtype: its float32 weight and bias are cast at
    the call. On a row shard (``spatial``) a 3×3 conv takes the neighbours'
    edge rows as its row padding: one row a side at stride 1; at stride 2,
    whose even shard's last output row reads its own last row, only the row
    above."""
    weight, bias = conv.weight.to(x.dtype), conv.bias.to(x.dtype)
    if spatial is None or conv.kernel_size[0] == 1:
        return F.conv2d(x, weight, bias, conv.stride, conv.padding)
    padded = nchw(pad_rows(nhwc(x), spatial, below=conv.stride[0] == 1))
    return F.conv2d(padded, weight, bias, conv.stride, (0, conv.padding[1]))


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

    def forward(self, x: torch.Tensor, group: int = 1,
                spatial: Optional[SpatialContext] = None) -> torch.Tensor:
        space_group = None if spatial is None else spatial.group
        return nchw(fused_instance_norm(nhwc(x), self.weight, self.bias, EPS, NEGATIVE_SLOPE,
                                        group, space_group))


class FusedActivation(nn.Identity):
    """The LeakyReLU slot of the reference ``block`` Sequential. The
    activation runs inside the preceding ``InstanceNorm`` (K1); this slot
    keeps the reference's state-dict indices."""


class ChannelDropout(nn.Module):
    """Channel dropout from an explicit generator: whole channels drop with
    probability ``rate`` and the kept ones scale by 1/(1 − rate), the mask
    broadcast over space (JAX ``nn.Dropout(broadcast_dims=(1, 2))``). With
    ``group=4`` the input is s2d and the mask also spans the 4 q blocks of
    each original channel. It holds no parameter: it keeps the reference's
    dropout index in the ``block`` Sequential."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator],
                group: int = 1) -> torch.Tensor:
        if not self.training or self.rate == 0:
            return x
        if generator is None:
            raise ValueError("channel dropout in training mode needs a torch.Generator "
                             "(UNet.forward(x, generator=...))")
        b, c = x.shape[:2]
        keep = 1.0 - self.rate
        draw = torch.rand((b, c // group), generator=generator, device=x.device)
        mask = (draw < keep).repeat(1, group)[:, :, None, None]
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class ConvBlock(nn.Module):
    """2 x [3x3 Conv -> InstanceNorm+LeakyReLU -> channel dropout]; the
    stride applies to the first conv only.

    Layouts (``forward`` arguments):
    - dense (default): ``x`` is a dense tensor, and the block runs the
      units of the reference's ``block`` Sequential in order;
    - ``s2d``: ``x`` is an s2d tensor, or with ``s2d_segments_first`` a tuple
      of s2d tensors whose logical channel-concat conv_0 takes without
      materializing it (segments: their dense channel counts); the output is
      s2d. In eval mode conv_0 is followed by the fused tail (K3) where
      ``region_applicable`` allows it: a width K3 takes, and a call autograd
      would not record (K3 has no backward). Otherwise, and in training, the
      block runs its module path;
    - ``s2d_input_first``: conv_0 is the stride-2 conv taking an s2d tensor,
      with a dense half-resolution output; the rest of the block is dense.

    ``spatial``: ``x`` is a dense row shard (see the module's docstring).
    """

    def __init__(self, cin: int, features: int, stride: int = 1, dropout_rate: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        layers = []
        c = cin
        for i in range(N_CONVS):
            layers += [
                kaiming_conv(c, features, 3, stride if i == 0 else 1, generator),
                InstanceNorm(features),
                FusedActivation(),
            ]
            if dropout_rate > 0:
                layers.append(ChannelDropout(dropout_rate))
            c = features
        self.block = nn.Sequential(*layers)
        self.dropout_rate = dropout_rate
        self.step = 4 if dropout_rate > 0 else 3

    def _unit(self, i: int):
        """(conv, norm) of conv unit i."""
        return self.block[i * self.step], self.block[i * self.step + 1]

    def _dropout(self, x: torch.Tensor, i: int, generator: Optional[torch.Generator],
                 group: int = 1) -> torch.Tensor:
        if self.dropout_rate == 0:
            return x
        return self.block[i * self.step + 3](x, generator, group)

    def _conv0(self, x, s2d_input_first: bool,
               segments: Optional[Tuple[int, ...]]) -> torch.Tensor:
        conv = self._unit(0)[0]
        if s2d_input_first:
            return nchw(conv_s2d_to_dense_stride2(nhwc(x), conv.weight, conv.bias))
        if segments is not None:
            return nchw(conv_s2d_multi([nhwc(xi) for xi in x], conv.weight, conv.bias,
                                       segments))
        return nchw(conv_s2d(nhwc(x), conv.weight, conv.bias))

    def forward(self, x, s2d: bool = False, s2d_input_first: bool = False,
                s2d_segments_first: Optional[Tuple[int, ...]] = None,
                generator: Optional[torch.Generator] = None,
                spatial: Optional[SpatialContext] = None) -> torch.Tensor:
        if s2d and s2d_input_first:
            raise ValueError("a block is s2d or takes an s2d input first, not both")
        if spatial is not None and (s2d or s2d_input_first):
            raise ValueError("a row shard runs the dense layout only")
        if s2d or s2d_input_first:
            x = self._conv0(x, s2d_input_first, s2d_segments_first)
        else:
            x = conv2d(x, self._unit(0)[0], spatial)
        if s2d and N_CONVS == 2 and not self.training:
            # The fused tail (K3): IN -> lrelu -> conv_1 -> IN -> lrelu.
            # Dropout is off in eval mode; conv_1's bias cancels in IN2.
            (_, norm0), (conv1, norm1) = self._unit(0), self._unit(1)
            tail = (nhwc(x), norm0.weight, norm0.bias, conv1.weight, norm1.weight, norm1.bias)
            if region_applicable(*tail):
                return nchw(fused_s2d_tail(*tail, EPS, NEGATIVE_SLOPE))
        group = 4 if s2d else 1
        for i in range(N_CONVS):
            conv, norm = self._unit(i)
            if i > 0:
                x = (nchw(conv_s2d(nhwc(x), conv.weight, conv.bias)) if s2d
                     else conv2d(x, conv, spatial))
            x = self._dropout(norm(x, group=group, spatial=spatial), i, generator, group)
        return x


class UpBlock(nn.Module):
    """Bilinear upsample to the skip's size, concat [upsampled, skip], ConvBlock.

    Dense: an exact 2x step goes through the K2a kernel, any other size ratio
    (odd input sizes) through ``resize_bilinear``, and the concat is
    materialized. On a row shard (``spatial``) the step must be an exact 2x,
    which K2a takes with one halo row a side. ``s2d``: ``skip`` is an s2d
    tensor at ``x``'s spatial size; K2b emits the upsample straight into s2d
    layout, and the two s2d tensors go to the block as segments, never
    concatenated.
    """

    def __init__(self, cin: int, skip_channels: int, features: int, dropout_rate: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv_block = ConvBlock(cin + skip_channels, features, 1, dropout_rate, generator)

    def forward(self, x: torch.Tensor, skip: torch.Tensor, s2d: bool = False,
                generator: Optional[torch.Generator] = None,
                spatial: Optional[SpatialContext] = None) -> torch.Tensor:
        size, skip_size = tuple(x.shape[2:]), tuple(skip.shape[2:])
        if s2d:
            if size != skip_size:
                raise ValueError(f"an s2d skip must match x spatially: {size} vs {skip_size}")
            up = nchw(upsample2x_into_s2d_fast(nhwc(x)))
            segments = (x.shape[1], skip.shape[1] // 4)
            return self.conv_block((up, skip), s2d=True, s2d_segments_first=segments,
                                   generator=generator)
        exact = skip_size == (2 * size[0], 2 * size[1])
        if spatial is not None:
            if not exact:
                raise ValueError(f"a row shard's decoder upsamples exactly 2x, not {size} to "
                                 f"{skip_size}")
            x = nhwc(x)
            x = nchw(upsample2x_nhwc_halo(x, *halo_rows(x, spatial, repeat_edges=True)))
        elif exact:
            x = nchw(upsample2x_nhwc_fast(nhwc(x)))
        elif size != skip_size:
            x = nchw(resize_bilinear(nhwc(x), skip_size))
        x = torch.cat([x, skip], dim=1).contiguous(memory_format=torch.channels_last)
        return self.conv_block(x, generator=generator, spatial=spatial)
