"""The parametric segmentation UNet as an ``nn.Module``.

Counterpart of ``unet_implementations_tpu/models/unet.py::UNet`` with the
segmentation head. The JAX model's space-to-depth paths are exact rewrites
of this dense model, so the port runs the dense model alone. Input is NHWC,
output NHWC float32 logits, as in JAX.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from unet_implementations_tpu_torch import default_device
from unet_implementations_tpu_torch.models.blocks import ConvBlock, UpBlock, kaiming_conv, nchw

# The 6-stage configuration the reference trains.
DEFAULT_FEATURES = (32, 64, 128, 256, 512, 512)
DEFAULT_STRIDES = (1, 2, 2, 2, 2, 2)
DEFAULT_ENC_DROPOUT = (0.0, 0.0, 0.1, 0.2, 0.3, 0.3)
DEFAULT_DEC_DROPOUT = (0.3, 0.2, 0.2, 0.1, 0.0)
IN_CHANNELS = 3  # RGB


class UNet(nn.Module):
    """Encoder stages with skips, a bottleneck stage, bilinear decoders with
    skip concat, and a 1x1 segmentation head.

    Convs hold ``dtype`` weights; InstanceNorm affines stay float32. The
    model is built on the CPU from ``generator`` (a fresh seed-0 generator
    when None); move it with ``.to(device)``.
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
    ):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        n = len(features_per_stage)
        self.features_per_stage = tuple(features_per_stage)
        self.encoder_dropout_rates = tuple(encoder_dropout_rates)
        self.decoder_dropout_rates = tuple(decoder_dropout_rates)
        self.dtype = dtype
        cin = IN_CHANNELS
        encoders = []
        for i in range(n):
            encoders.append(ConvBlock(cin, features_per_stage[i], strides[i],
                                      encoder_dropout_rates[i], dtype, generator))
            cin = features_per_stage[i]
        self.encoder_stages = nn.ModuleList(encoders)
        decoders = []
        for d in range(n - 1):
            feats = features_per_stage[n - 2 - d]
            decoders.append(UpBlock(cin, feats, feats, decoder_dropout_rates[d], dtype,
                                    generator))
            cin = feats
        self.decoder_stages = nn.ModuleList(decoders)
        self.segmentation_output = kaiming_conv(cin, num_classes, 1, 1, dtype, generator)

    @property
    def n_stages(self) -> int:
        return len(self.features_per_stage)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C_in) -> (B, H, W, num_classes) float32 logits."""
        x = nchw(x.to(self.dtype)).contiguous(memory_format=torch.channels_last)
        skips = []
        for stage in self.encoder_stages[:-1]:
            x = stage(x)
            skips.append(x)
        x = self.encoder_stages[-1](x)
        for decoder, skip in zip(self.decoder_stages, reversed(skips)):
            x = decoder(x, skip)
        return self.segmentation_output(x).permute(0, 2, 3, 1).to(torch.float32)


def unet_6stage(dtype: torch.dtype = torch.float32, device=None,
                generator: Optional[torch.Generator] = None) -> UNet:
    """The 6-stage segmentation UNet the reference trains, on ``device``
    (CUDA unless the caller names another device)."""
    device = default_device(device)
    return UNet(dtype=dtype, generator=generator).to(device)
