"""The parametric UNet as an ``nn.Module``.

Counterpart of ``unet_implementations_tpu/models/unet.py::UNet`` with the
segmentation head (1x1 conv to logits) or the reconstruction head (3x3 conv to
3 channels, then a float32 sigmoid: the autoencoder), in the dense layout and
in the JAX model's space-to-depth layout (``s2d_level0``,
``s2d_low_channel_decoders``), which is an exact rewrite of the dense model.
Input is NHWC, output NHWC float32 logits or [0, 1] reconstructions, as in
JAX. The encoder-transfer model is the segmentation UNet with its encoder
grafted from an autoencoder and frozen (``recipes/ae_transfer.py``). The
CLIP_UNet model is the segmentation UNet with ``clip_fusion``: a global
(B, clip_dim) image embedding fused at the bottleneck. Under spatial
partitioning (``parallel/spatial.py``) the model runs on a row shard of each
image, in either layout. ``remat`` recomputes each block's activations in the backward
(JAX's ``nn.remat``), with the same channel-dropout masks.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from unet_implementations_tpu_torch import default_device
from unet_implementations_tpu_torch.models.blocks import (
    ConvBlock,
    InstanceNorm,
    UpBlock,
    conv2d,
    kaiming_conv,
    nchw,
    nhwc,
    plain_conv2d,
    s2d_conv,
)
from unet_implementations_tpu_torch.ops.s2d import depth_to_space, space_to_depth
from unet_implementations_tpu_torch.parallel.spatial import SpatialContext

# The 6-stage configuration the reference trains.
DEFAULT_FEATURES = (32, 64, 128, 256, 512, 512)
DEFAULT_STRIDES = (1, 2, 2, 2, 2, 2)
DEFAULT_ENC_DROPOUT = (0.0, 0.0, 0.1, 0.2, 0.3, 0.3)
DEFAULT_DEC_DROPOUT = (0.3, 0.2, 0.2, 0.1, 0.0)
# The autoencoder's lowered dropout schedule.
AE_ENC_DROPOUT = (0.0, 0.0, 0.05, 0.1, 0.15, 0.15)
AE_DEC_DROPOUT = (0.15, 0.1, 0.1, 0.05, 0.0)
HEADS = ("segmentation", "reconstruction")
IN_CHANNELS = 3  # RGB
# The JAX model's default layout: level 0, and the decoders under 128
# channels, in space-to-depth. Keywords of ``UNet`` and ``unet_6stage``.
S2D_LAYOUT = {"s2d_level0": True, "s2d_low_channel_decoders": True}


def remat_call(fn: Callable, args: tuple, generator: Optional[torch.Generator]):
    """``fn(*args, generator)`` under ``torch.utils.checkpoint`` (non-
    reentrant): only its inputs are saved, and the backward reruns it.

    Channel dropout draws from ``generator``, an explicit generator that the
    checkpoint's ``preserve_rng_state`` does not cover: the rerun would draw
    new masks and the gradients would be wrong. So every run of ``fn`` draws
    from a fresh generator set to the state ``generator`` has now, and after
    the forward ``generator`` takes the state the first run left, as if it had
    drawn the masks itself."""
    if generator is None:
        return checkpoint(lambda *a: fn(*a, None), *args, use_reentrant=False)
    state = generator.get_state()
    runs = []

    def run(*a):
        g = torch.Generator(device=generator.device)
        g.set_state(state)
        runs.append(g)
        return fn(*a, g)

    out = checkpoint(run, *args, use_reentrant=False)
    generator.set_state(runs[0].get_state())
    return out


class UNet(nn.Module):
    """Encoder stages with skips, a bottleneck stage, bilinear decoders with
    skip concat, and a head: ``head="segmentation"``, a 1x1 conv to
    ``num_classes`` logits (``segmentation_output``); ``"reconstruction"``, a
    3x3 conv to 3 channels and a sigmoid in float32 (``reconstruction_output``,
    a one-conv Sequential, as the reference autoencoder's state dict has it).

    ``clip_fusion`` adds, after the bottleneck stage, the CLIP_UNet fusion:
    the (B, clip_dim) features broadcast over the bottleneck grid and
    concatenated after its channels (UNet features first), then a 1x1 conv
    back to the bottleneck width and K1's InstanceNorm+LeakyReLU
    (``clip_fusion_conv``: keys ``.0`` conv and ``.1`` norm, the reference's;
    drawn after every other parameter, so the rest of the model's init does
    not depend on it). The bottleneck is dense in both layouts.

    Every parameter is float32, as in the JAX model; ``dtype`` is the
    compute dtype, to which each conv casts its weight and bias at the call
    (the InstanceNorm affines stay float32 in the norm). The model is built
    on the CPU from ``generator`` (a fresh seed-0 generator when None); move
    it with ``.to(device)``. In training mode its channel dropout draws from
    the generator ``forward`` is given.

    ``kernel_size`` (the k×k of every block conv, padding k//2),
    ``n_conv_per_stage`` and ``n_conv_per_stage_decoder`` (conv units per
    encoder and decoder block) and ``remat`` are JAX's fields with its
    defaults (3, 2, 2, False). A kernel size other than 3 turns off the s2d
    feed of encoder_1, keeps it dense, and runs no decoder in s2d, as in JAX.
    ``remat``: in training with grad enabled, each encoder stage and each
    decoder runs under ``remat_call``, which saves only its inputs and
    recomputes the rest in the backward.

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
        head: str = "segmentation",
        clip_fusion: bool = False,
        clip_dim: int = 512,
        kernel_size: int = 3,
        n_conv_per_stage: int = 2,
        n_conv_per_stage_decoder: int = 2,
        remat: bool = False,
    ):
        super().__init__()
        if head not in HEADS:
            raise ValueError(f"head must be one of {HEADS}, got {head!r}")
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
        self.head = head
        self.clip_fusion = clip_fusion
        self.clip_dim = clip_dim
        self.kernel_size = kernel_size
        self.n_conv_per_stage = n_conv_per_stage
        self.n_conv_per_stage_decoder = n_conv_per_stage_decoder
        self.remat = remat
        cin = IN_CHANNELS
        encoders = []
        for i in range(n):
            encoders.append(ConvBlock(cin, features_per_stage[i], strides[i],
                                      encoder_dropout_rates[i], generator, n_conv_per_stage,
                                      kernel_size))
            cin = features_per_stage[i]
        self.encoder_stages = nn.ModuleList(encoders)
        decoders = []
        for d in range(n - 1):
            feats = features_per_stage[n - 2 - d]
            decoders.append(UpBlock(cin, feats, feats, decoder_dropout_rates[d], generator,
                                    n_conv_per_stage_decoder, kernel_size))
            cin = feats
        self.decoder_stages = nn.ModuleList(decoders)
        if head == "segmentation":
            self.segmentation_output = kaiming_conv(cin, num_classes, 1, 1, generator)
        else:
            self.reconstruction_output = nn.Sequential(kaiming_conv(cin, IN_CHANNELS, 3, 1,
                                                                    generator))
        if clip_fusion:
            width = features_per_stage[-1]
            self.clip_fusion_conv = nn.Sequential(
                kaiming_conv(width + clip_dim, width, 1, 1, generator), InstanceNorm(width))

    @property
    def n_stages(self) -> int:
        return len(self.features_per_stage)

    def forward(self, x: torch.Tensor, clip_features: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, return_bottleneck: bool = False,
                spatial: Optional[SpatialContext] = None):
        """(B, H, W, C_in) -> (B, H, W, num_classes) float32 logits, or
        (B, H, W, 3) float32 reconstructions in [0, 1].

        ``clip_features`` (B, clip_dim) feeds the bottleneck fusion of a
        ``clip_fusion`` model; None skips the fusion (the reference
        evaluator's path), and a model without fusion ignores it, as JAX's.

        ``generator`` (on x's device) drives channel dropout in training
        mode; a training forward through a block with a dropout rate above
        0 raises without one. ``return_bottleneck`` also returns the
        bottleneck stage's output flattened in NHWC order, (B, H'·W'·C), in
        the compute dtype, as JAX's.

        ``spatial``: ``x`` is this rank's row shard (B, H/S, W, C_in) of the
        images of a space group of S ranks, and so is the output (JAX's
        spatially sharded forward), in either layout. The shards must stay
        equal and even at every level: H divisible by 2^(stages-1)·S; and
        each level's shard must hold the k//2 halo rows its k×k convs take
        from each neighbour: H at least 2^(stages-1)·S·(k//2)."""
        n = self.n_stages
        if spatial is not None:
            down = math.prod(self.strides)
            height = x.shape[1] * spatial.size
            if x.shape[1] % down:
                raise ValueError(
                    f"spatial partitioning: images of {height} rows over "
                    f"{spatial.size} ranks leave shards that are not equal and even at every "
                    f"level; H must be divisible by {down}·{spatial.size}")
            if x.shape[1] // down < self.kernel_size // 2:
                least = down * spatial.size * (self.kernel_size // 2)
                raise ValueError(
                    f"spatial partitioning with kernel_size {self.kernel_size}: each level's "
                    f"shard must hold the {self.kernel_size // 2} rows a conv takes from each "
                    f"neighbour; images of {height} rows over {spatial.size} ranks leave "
                    f"{x.shape[1] // down} at the deepest level; H must be at least {least}")
        x = nchw(x.to(self.dtype)).contiguous(memory_format=torch.channels_last)
        # The JAX model's rules: the s2d level needs even sizes and a
        # stride-1 first stage; encoder_1 then takes the s2d skip through a
        # transformed stride-2 conv, which needs a 3×3 kernel.
        use_s2d = (self.s2d_level0 and self.strides[0] == 1
                   and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0)
        feed_s2d = use_s2d and n > 2 and self.strides[1] == 2 and self.kernel_size == 3
        skips = []
        for i, stage in enumerate(self.encoder_stages[:-1]):
            s2d_stage = use_s2d and i == 0
            if s2d_stage:
                x = nchw(space_to_depth(nhwc(x)))
            x = self._block(stage, (x,), generator, s2d=s2d_stage,
                            s2d_input_first=feed_s2d and i == 1, spatial=spatial)
            skips.append(x)  # skip 0 stays s2d for the last decoder
            if s2d_stage and not feed_s2d:
                x = nchw(depth_to_space(nhwc(x)))
        x = self._block(self.encoder_stages[-1], (x,), generator, spatial=spatial)
        if self.clip_fusion and clip_features is not None:
            x = self._fuse(x, clip_features, spatial)
        bottleneck = x
        for d, decoder in enumerate(self.decoder_stages):
            skip_idx = n - 2 - d
            skip = skips[skip_idx]
            feats = self.features_per_stage[skip_idx]
            s2d_stage = use_s2d and skip_idx == 0
            # Decoders under 128 channels run in s2d too (the JAX rule).
            s2d_wrap = (self.s2d_low_channel_decoders and not s2d_stage
                        and feats < 128 and (4 * feats) % 128 == 0 and self.kernel_size == 3
                        and skip.shape[2] == 2 * x.shape[2] and skip.shape[3] == 2 * x.shape[3]
                        and skip.shape[2] % 2 == 0 and skip.shape[3] % 2 == 0)
            if s2d_wrap:
                skip = nchw(space_to_depth(nhwc(skip)))
            x = self._block(decoder, (x, skip), generator, s2d=s2d_stage or s2d_wrap,
                            spatial=spatial)
            if s2d_wrap:
                x = nchw(depth_to_space(nhwc(x)))
        head = (self.segmentation_output if self.head == "segmentation"
                else self.reconstruction_output[0])
        if use_s2d:
            out = depth_to_space(nhwc(s2d_conv(x, head, spatial)))
        else:
            out = nhwc(conv2d(x, head, spatial))
        out = out.to(torch.float32)
        if self.head == "reconstruction":
            out = torch.sigmoid(out)
        if return_bottleneck:
            return out, nhwc(bottleneck).reshape(bottleneck.shape[0], -1)
        return out

    def _block(self, block: nn.Module, args: tuple, generator, **kwargs) -> torch.Tensor:
        """``block(*args, generator=generator, **kwargs)``; under ``remat`` in
        training with grad enabled, through ``remat_call``."""
        def fn(*a):
            return block(*a[:-1], generator=a[-1], **kwargs)

        if self.remat and self.training and torch.is_grad_enabled():
            return remat_call(fn, args, generator)
        return fn(*args, generator)

    def load_reference_state_dict(self, sd: dict) -> "UNet":
        """``load_state_dict(sd, strict=True)``, except that a ``clip_fusion``
        model also takes a state dict that holds none of ``clip_fusion_conv``'s
        keys, and leaves the fusion at its init: the reference builds its
        fusion lazily, so such files exist, and the JAX converter loads them
        so. A partial fusion, and every other key, stays strict. Returns the
        model."""
        fusion = {k: v for k, v in self.state_dict().items()
                  if k.startswith("clip_fusion_conv.")}
        if fusion and not any(k in sd for k in fusion):
            sd = {**sd, **fusion}
        self.load_state_dict(sd, strict=True)
        return self

    def _fuse(self, x: torch.Tensor, clip_features: torch.Tensor,
              spatial: Optional[SpatialContext] = None) -> torch.Tensor:
        """The bottleneck fusion: concat [x, features broadcast over x's
        grid], 1x1 conv, InstanceNorm+LeakyReLU (K1)."""
        b, _, h, w = x.shape
        cf = clip_features.to(device=x.device, dtype=self.dtype)
        cf = cf[:, :, None, None].expand(b, self.clip_dim, h, w)
        x = torch.cat([x, cf], dim=1).contiguous(memory_format=torch.channels_last)
        conv, norm = self.clip_fusion_conv[0], self.clip_fusion_conv[1]
        return norm(plain_conv2d(x, conv), spatial=spatial)


def unet_6stage(dtype: torch.dtype = torch.float32, device=None,
                generator: Optional[torch.Generator] = None, s2d_level0: bool = False,
                s2d_low_channel_decoders: bool = False, clip_fusion: bool = False,
                clip_dim: int = 512) -> UNet:
    """The 6-stage segmentation UNet the reference trains, on ``device``
    (CUDA unless the caller names another device), in the dense layout or,
    with the two flags, in the JAX model's space-to-depth layout; with
    ``clip_fusion``, the CLIP_UNet model (``clip_dim``: the encoder's output
    width, 512 for ViT-B/16 and B/32, 768 for ViT-L/14)."""
    device = default_device(device)
    return UNet(dtype=dtype, generator=generator, s2d_level0=s2d_level0,
                s2d_low_channel_decoders=s2d_low_channel_decoders, clip_fusion=clip_fusion,
                clip_dim=clip_dim).to(device)


def autoencoder_6stage(dtype: torch.dtype = torch.float32, device=None,
                       generator: Optional[torch.Generator] = None, s2d_level0: bool = False,
                       s2d_low_channel_decoders: bool = False) -> UNet:
    """The reconstruction autoencoder: ``unet_6stage``'s topology with the
    reconstruction head and the lowered dropout, on ``device`` (CUDA unless
    the caller names another device)."""
    device = default_device(device)
    return UNet(encoder_dropout_rates=AE_ENC_DROPOUT, decoder_dropout_rates=AE_DEC_DROPOUT,
                dtype=dtype, generator=generator, s2d_level0=s2d_level0,
                s2d_low_channel_decoders=s2d_low_channel_decoders,
                head="reconstruction").to(device)


def encoder_param_names(n_stages: int = 6) -> Tuple[str, ...]:
    """The submodules that form the transferable encoder (the JAX names are
    ``encoder_{i}``; here ``encoder_stages.{i}``), bottleneck included."""
    return tuple(f"encoder_stages.{i}" for i in range(n_stages))
