"""The parametric segmentation UNet as an ``nn.Module``.

Counterpart of ``unet_implementations_tpu/models/unet.py::UNet`` with the
segmentation head, in the dense layout and in the JAX model's space-to-depth
layout (``s2d_level0``, ``s2d_low_channel_decoders``), which is an exact
rewrite of the dense model. Input is NHWC, output NHWC float32 logits, as in
JAX.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from unet_implementations_tpu_torch import default_device
from unet_implementations_tpu_torch.models.blocks import (
    ConvBlock,
    UpBlock,
    conv2d,
    kaiming_conv,
    nchw,
    nhwc,
)
from unet_implementations_tpu_torch.models.s2d import conv_s2d, depth_to_space, space_to_depth

# The 6-stage configuration the reference trains.
DEFAULT_FEATURES = (32, 64, 128, 256, 512, 512)
DEFAULT_STRIDES = (1, 2, 2, 2, 2, 2)
DEFAULT_ENC_DROPOUT = (0.0, 0.0, 0.1, 0.2, 0.3, 0.3)
DEFAULT_DEC_DROPOUT = (0.3, 0.2, 0.2, 0.1, 0.0)
IN_CHANNELS = 3  # RGB
# The JAX model's default layout: level 0, and the decoders under 128
# channels, in space-to-depth. Keywords of ``UNet`` and ``unet_6stage``.
S2D_LAYOUT = {"s2d_level0": True, "s2d_low_channel_decoders": True}


class UNet(nn.Module):
    """Encoder stages with skips, a bottleneck stage, bilinear decoders with
    skip concat, and a 1x1 segmentation head.

    Every parameter is float32, as in the JAX model; ``dtype`` is the
    compute dtype, to which each conv casts its weight and bias at the call
    (the InstanceNorm affines stay float32 in the norm). The model is built
    on the CPU from ``generator`` (a fresh seed-0 generator when None); move
    it with ``.to(device)``. In training mode its channel dropout draws from
    the generator ``forward`` is given.

    ``s2d_level0`` runs the full-resolution level (encoder_0, the last
    decoder, the head) in space-to-depth layout, and
    ``s2d_low_channel_decoders`` the decoders under 128 channels too; both
    keep the JAX names and rules and change no parameter. They default to
    False here, unlike in JAX, whose defaults were set by the TPU's lane
    padding: on Hopper an s2d 3×3 conv through cuDNN multiplies 4× the MACs
    with no padding to win back, so the default waits for the timed b128
    forwards of both layouts.
    """

    def __init__(
        self,
        num_classes: int = 3,
        features_per_stage: Sequence[int] = DEFAULT_FEATURES,
        strides: Sequence[int] = DEFAULT_STRIDES,
        encoder_dropout_rates: Sequence[float] = DEFAULT_ENC_DROPOUT,
        decoder_dropout_rates: Sequence[float] = DEFAULT_DEC_DROPOUT,
        dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
        s2d_level0: bool = False,
        s2d_low_channel_decoders: bool = False,
    ):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        n = len(features_per_stage)
        self.features_per_stage = tuple(features_per_stage)
        self.strides = tuple(strides)
        self.s2d_level0 = s2d_level0
        self.s2d_low_channel_decoders = s2d_low_channel_decoders
        self.encoder_dropout_rates = tuple(encoder_dropout_rates)
        self.decoder_dropout_rates = tuple(decoder_dropout_rates)
        self.dtype = dtype
        cin = IN_CHANNELS
        encoders = []
        for i in range(n):
            encoders.append(ConvBlock(cin, features_per_stage[i], strides[i],
                                      encoder_dropout_rates[i], generator))
            cin = features_per_stage[i]
        self.encoder_stages = nn.ModuleList(encoders)
        decoders = []
        for d in range(n - 1):
            feats = features_per_stage[n - 2 - d]
            decoders.append(UpBlock(cin, feats, feats, decoder_dropout_rates[d], generator))
            cin = feats
        self.decoder_stages = nn.ModuleList(decoders)
        self.segmentation_output = kaiming_conv(cin, num_classes, 1, 1, generator)

    @property
    def n_stages(self) -> int:
        return len(self.features_per_stage)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, H, W, C_in) -> (B, H, W, num_classes) float32 logits.

        ``generator`` (on x's device) drives channel dropout in training
        mode; a training forward through a block with a dropout rate above
        0 raises without one."""
        n = self.n_stages
        x = nchw(x.to(self.dtype)).contiguous(memory_format=torch.channels_last)
        # The JAX model's rules: the s2d level needs even sizes and a
        # stride-1 first stage; encoder_1 then takes the s2d skip through a
        # transformed stride-2 conv.
        use_s2d = (self.s2d_level0 and self.strides[0] == 1
                   and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0)
        feed_s2d = use_s2d and n > 2 and self.strides[1] == 2
        skips = []
        for i, stage in enumerate(self.encoder_stages[:-1]):
            s2d_stage = use_s2d and i == 0
            if s2d_stage:
                x = nchw(space_to_depth(nhwc(x)))
            x = stage(x, s2d=s2d_stage, s2d_input_first=feed_s2d and i == 1, generator=generator)
            skips.append(x)  # skip 0 stays s2d for the last decoder
            if s2d_stage and not feed_s2d:
                x = nchw(depth_to_space(nhwc(x)))
        x = self.encoder_stages[-1](x, generator=generator)
        for d, decoder in enumerate(self.decoder_stages):
            skip_idx = n - 2 - d
            skip = skips[skip_idx]
            feats = self.features_per_stage[skip_idx]
            s2d_stage = use_s2d and skip_idx == 0
            # Decoders under 128 channels run in s2d too (the JAX rule).
            s2d_wrap = (self.s2d_low_channel_decoders and not s2d_stage
                        and feats < 128 and (4 * feats) % 128 == 0
                        and skip.shape[2] == 2 * x.shape[2] and skip.shape[3] == 2 * x.shape[3]
                        and skip.shape[2] % 2 == 0 and skip.shape[3] % 2 == 0)
            if s2d_wrap:
                skip = nchw(space_to_depth(nhwc(skip)))
            x = decoder(x, skip, s2d=s2d_stage or s2d_wrap, generator=generator)
            if s2d_wrap:
                x = nchw(depth_to_space(nhwc(x)))
        head = self.segmentation_output
        if use_s2d:
            out = depth_to_space(conv_s2d(nhwc(x), head.weight, head.bias))
        else:
            out = nhwc(conv2d(x, head))
        return out.to(torch.float32)


def unet_6stage(dtype: torch.dtype = torch.float32, device=None,
                generator: Optional[torch.Generator] = None, s2d_level0: bool = False,
                s2d_low_channel_decoders: bool = False) -> UNet:
    """The 6-stage segmentation UNet the reference trains, on ``device``
    (CUDA unless the caller names another device), in the dense layout or,
    with the two flags, in the JAX model's space-to-depth layout."""
    device = default_device(device)
    return UNet(dtype=dtype, generator=generator, s2d_level0=s2d_level0,
                s2d_low_channel_decoders=s2d_low_channel_decoders).to(device)
