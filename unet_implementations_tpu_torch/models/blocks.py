"""UNet building blocks as ``nn.Module``s, dense and space-to-depth.

Counterpart of ``unet_implementations_tpu/models/blocks.py``. Activations
are NCHW tensors in ``channels_last`` memory, so the kernels see NHWC-
contiguous memory through a ``permute`` view and cuDNN convs take the same
tensors without a copy. A space-to-depth (s2d) activation is the NCHW view
(B, 4C, H′, W′) of a q-major NHWC tensor (``ops/s2d.py``).

Where JAX sets a block's layout as a module field, these blocks take it as a
``forward`` argument (``s2d``, ``s2d_input_first``, ``s2d_segments_first``,
``up_fold_first``), since the UNet decides it from the input's size at each
call. The layout changes no parameter: each ``nn.Conv2d.weight`` is the
canonical kernel, and the s2d convs transform it at call time.

Parameters are float32, as the JAX model's (flax's default ``param_dtype``);
every conv casts its weight and bias to the activation's dtype at the call,
as the JAX ``ConvOp`` does, so a bf16 model trains float32 masters. Every
conv of a block goes through ``ops/quant.py::qconv_sum`` (the fp8 conv mode,
off by default). Channel dropout draws from the ``torch.Generator`` passed
down from ``UNet.forward``.

A dense decoder does not materialize the concat of its upsampled input and
its skip: conv_0 takes the pair and sums the two segments' convs, as JAX's
``ConvOp`` does with a tuple input. Where JAX's policies fold the upsample
into conv_0 (``ops/s2d.py``: ``up_fold_enabled`` for an s2d decoder,
``dense_up_fold_enabled`` for a dense one; both off unless their variable is
set), the pair's first segment is the tensor before the upsample, and no K2
runs.

Under spatial partitioning ``UNet.forward`` also passes down a
``parallel/spatial.py::SpatialContext``: the blocks then run on a row shard
of each image, in either layout. A conv pads the shard with its neighbours'
edge rows (``pad_rows``, as many as it reads; a split conv pads each
segment), K1 normalizes with the whole images' statistics, K2a and K2b
upsample the shard with one halo row a side (``upsample2x_nhwc_halo``,
``upsample2x_into_s2d_halo``), a folded upsample takes one neighbour row
beyond each inner edge (``neighbour_rows``), and an s2d block runs its
module path, not K3.
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
    upsample2x_into_s2d_halo,
    upsample2x_nhwc_fast,
    upsample2x_nhwc_halo,
)
from unet_implementations_tpu_torch.ops.quant import qconv_sum, quantizes
from unet_implementations_tpu_torch.ops.s2d import (
    RowShard,
    conv_dense_up_fold,
    conv_s2d,
    conv_s2d_multi,
    conv_s2d_multi_up_fold,
    conv_s2d_to_dense_stride2,
    dense_up_fold_enabled,
    halo_of,
    up_fold_enabled,
)
from unet_implementations_tpu_torch.ops.resize import resize_bilinear
from unet_implementations_tpu_torch.parallel.spatial import (
    SpatialContext,
    halo_rows,
    neighbour_rows,
    pad_rows,
)


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


def plain_conv2d(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """``conv`` in x's dtype through ``F.conv2d`` alone: the convs that JAX
    runs as ``nn.Conv`` (the CLIP fusion, VGG16), which the fp8 mode does not
    take."""
    return F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype), conv.stride,
                    conv.padding)


def conv2d(x, conv: nn.Conv2d, spatial: Optional[SpatialContext] = None) -> torch.Tensor:
    """``conv`` applied in the activation's dtype (its float32 weight and bias
    are cast at the call) through ``qconv_sum``. ``x`` is an NCHW tensor, or a
    tuple of them whose logical channel-concat the conv takes without
    materializing it: the sum of each segment's conv by its slice of the
    kernel, the bias once. On a row shard (``spatial``) a k×k conv takes the
    neighbours' edge rows as its row padding, each segment its own: k//2 a
    side at stride 1; at stride 2, whose even shard's last output row reads
    k − 2 − k//2 rows below the shard (none for k = 3), k//2 above and that
    many below. The fp8 policy then sees the whole image's rows."""
    xs = x if isinstance(x, tuple) else (x,)
    weight, bias = conv.weight.to(xs[0].dtype), conv.bias.to(xs[0].dtype)
    weights = (weight,) if len(xs) == 1 else weight.split([xi.shape[1] for xi in xs], dim=1)
    stride, pad = conv.stride[0], conv.padding[0]
    rows = None if spatial is None else xs[0].shape[2] * spatial.size
    if spatial is not None and conv.kernel_size[0] > 1:
        below = conv.kernel_size[0] - stride - pad
        xs = [nchw(pad_rows(nhwc(xi), spatial, pad, below)) for xi in xs]
        return qconv_sum(xs, weights, bias, stride, (0, 0, pad, pad), rows)
    return qconv_sum(xs, weights, bias, stride, pad, rows)


def s2d_rows(x: torch.Tensor, spatial: Optional[SpatialContext], above: int,
             below: int) -> tuple:
    """(x NHWC, rows) for an s2d conv of the NCHW view x: on a row shard, x
    padded with its halo rows and the whole grid's rows; else x and None."""
    if spatial is None:
        return nhwc(x), None
    return pad_rows(nhwc(x), spatial, above, below), x.shape[2] * spatial.size


def s2d_conv(x: torch.Tensor, conv: nn.Conv2d,
             spatial: Optional[SpatialContext] = None) -> torch.Tensor:
    """``conv_s2d`` of the s2d activation x (an NCHW view) by ``conv``'s
    canonical kernel; on a row shard with K′//2 halo rows a side."""
    n = halo_of(conv.kernel_size[0])
    xp, rows = s2d_rows(x, spatial, n, n)
    return nchw(conv_s2d(xp, conv.weight, conv.bias, rows=rows))


# The reference block: InstanceNorm2d(eps=1e-5, affine) + LeakyReLU(0.01)
# after every conv.
EPS = 1e-5
NEGATIVE_SLOPE = 0.01


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
    """n_convs x [k×k Conv (padding k//2) -> InstanceNorm+LeakyReLU ->
    channel dropout]; the stride applies to the first conv only.

    Layouts (``forward`` arguments):
    - dense (default): ``x`` is a dense tensor, or a tuple of them that conv_0
      takes as one channel-concat (``conv2d``), and the block runs the units
      of the reference's ``block`` Sequential in order;
    - ``s2d``: ``x`` is an s2d tensor, or with ``s2d_segments_first`` a tuple
      of s2d tensors whose logical channel-concat conv_0 takes without
      materializing it (segments: their dense channel counts); the output is
      s2d. In eval mode a two-conv block follows conv_0 with the fused tail
      (K3) where ``region_applicable`` allows it (a 3×3 kernel, a width K3
      takes, and a call autograd would not record: K3 has no backward), the
      fp8 policy would not quantize conv_1 (JAX's tail quantizes it through
      ``conv_s2d``) and the block is not on a row shard. Otherwise, and in
      training, the block runs its module path;
    - ``s2d_input_first``: conv_0 is the stride-2 conv taking an s2d tensor,
      with a dense half-resolution output; the rest of the block is dense.

    ``up_fold_first``: x is a pair whose first segment is the decoder's input
    before its 2x upsample, which conv_0 folds in (``_folded_conv0``), in
    either layout.

    ``spatial``: ``x`` is a row shard (see the module's docstring).
    """

    def __init__(self, cin: int, features: int, stride: int = 1, dropout_rate: float = 0.0,
                 generator: Optional[torch.Generator] = None, n_convs: int = 2,
                 kernel_size: int = 3):
        super().__init__()
        layers = []
        c = cin
        for i in range(n_convs):
            layers += [
                kaiming_conv(c, features, kernel_size, stride if i == 0 else 1, generator),
                InstanceNorm(features),
                FusedActivation(),
            ]
            if dropout_rate > 0:
                layers.append(ChannelDropout(dropout_rate))
            c = features
        self.block = nn.Sequential(*layers)
        self.n_convs = n_convs
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

    def _conv0(self, x, s2d: bool, s2d_input_first: bool, segments: Optional[Tuple[int, ...]],
               up_fold: bool, spatial: Optional[SpatialContext]) -> torch.Tensor:
        conv = self._unit(0)[0]
        if up_fold:
            return self._folded_conv0(x, s2d, segments, spatial)
        if s2d_input_first:
            xp, rows = s2d_rows(x, spatial, 1, 0)
            return nchw(conv_s2d_to_dense_stride2(xp, conv.weight, conv.bias, rows))
        if segments is not None:
            n = halo_of(conv.kernel_size[0])
            padded = [s2d_rows(xi, spatial, n, n) for xi in x]
            return nchw(conv_s2d_multi([xp for xp, _ in padded], conv.weight, conv.bias,
                                       segments, padded[0][1]))
        if s2d:
            return s2d_conv(x, conv, spatial)
        return conv2d(x, conv, spatial)

    def _folded_conv0(self, x: tuple, s2d: bool, segments: Optional[Tuple[int, ...]],
                      spatial: Optional[SpatialContext]) -> torch.Tensor:
        """conv_0 of (pre-upsample x, *rest) with the upsample folded in: the
        s2d fold (``conv_s2d_multi_up_fold``) or the dense one
        (``conv_dense_up_fold``). On a row shard the pre-upsample rows take a
        neighbour row beyond each inner edge, the rest their halo rows."""
        conv = self._unit(0)[0]
        pre, rest = nhwc(x[0]), [nhwc(xi) for xi in x[1:]]
        shard = None
        if spatial is not None:
            shard = RowShard(pre.shape[1] * spatial.size, spatial.first, spatial.last)
            pre = neighbour_rows(pre, spatial)
            rest = [pad_rows(xi, spatial) for xi in rest]
        if s2d:
            return nchw(conv_s2d_multi_up_fold(pre, rest, conv.weight, conv.bias, segments, shard))
        return nchw(conv_dense_up_fold(pre, rest, conv.weight, conv.bias, shard))

    def forward(self, x, s2d: bool = False, s2d_input_first: bool = False,
                s2d_segments_first: Optional[Tuple[int, ...]] = None,
                generator: Optional[torch.Generator] = None,
                spatial: Optional[SpatialContext] = None,
                up_fold_first: bool = False) -> torch.Tensor:
        if s2d and s2d_input_first:
            raise ValueError("a block is s2d or takes an s2d input first, not both")
        x = self._conv0(x, s2d, s2d_input_first, s2d_segments_first, up_fold_first, spatial)
        if (s2d and self.n_convs == 2 and not self.training and spatial is None
                and not quantizes(x)):
            # The fused tail (K3): IN -> lrelu -> conv_1 -> IN -> lrelu.
            # Dropout is off in eval mode; conv_1's bias cancels in IN2. Not
            # on a row shard: K3's statistics and zero padding span the
            # tensor it is given.
            (_, norm0), (conv1, norm1) = self._unit(0), self._unit(1)
            tail = (nhwc(x), norm0.weight, norm0.bias, conv1.weight, norm1.weight, norm1.bias)
            if region_applicable(*tail):
                return nchw(fused_s2d_tail(*tail, EPS, NEGATIVE_SLOPE))
        group = 4 if s2d else 1
        for i in range(self.n_convs):
            conv, norm = self._unit(i)
            if i > 0:
                x = s2d_conv(x, conv, spatial) if s2d else conv2d(x, conv, spatial)
            x = self._dropout(norm(x, group=group, spatial=spatial), i, generator, group)
        return x


class UpBlock(nn.Module):
    """Bilinear upsample to the skip's size, logical concat [upsampled, skip],
    ConvBlock.

    Dense: an exact 2x step goes through the K2a kernel, any other size ratio
    (odd input sizes) through ``resize_bilinear``, and the pair goes to the
    block's conv_0 as two segments, never concatenated. ``s2d``: ``skip`` is
    an s2d tensor at ``x``'s spatial size; K2b emits the upsample straight
    into s2d layout, and the two s2d tensors go to the block as segments,
    never concatenated.

    The upsample folds into conv_0 instead (no K2 launch; conv_0 gets x
    before the upsample) under JAX's rules: s2d, where ``up_fold_enabled()``
    and the coarse grid is at least 3×3; dense, where the step is an exact 2x,
    ``dense_up_fold_enabled(not self.training)``, the kernel is 3×3 and the
    coarse grid at least 3×3. The grid is the whole image's: on a row shard
    (``spatial``) its rows are the shard's times the space group's size.

    On a row shard the step must be an exact 2x, which K2a and K2b take with
    one halo row a side.
    """

    def __init__(self, cin: int, skip_channels: int, features: int, dropout_rate: float = 0.0,
                 generator: Optional[torch.Generator] = None, n_convs: int = 2,
                 kernel_size: int = 3):
        super().__init__()
        self.kernel_size = kernel_size
        self.conv_block = ConvBlock(cin + skip_channels, features, 1, dropout_rate, generator,
                                    n_convs, kernel_size)

    def forward(self, x: torch.Tensor, skip: torch.Tensor, s2d: bool = False,
                generator: Optional[torch.Generator] = None,
                spatial: Optional[SpatialContext] = None) -> torch.Tensor:
        size, skip_size = tuple(x.shape[2:]), tuple(skip.shape[2:])
        grid = min(size[0] * (1 if spatial is None else spatial.size), size[1])
        if s2d:
            if size != skip_size:
                raise ValueError(f"an s2d skip must match x spatially: {size} vs {skip_size}")
            segments = (x.shape[1], skip.shape[1] // 4)
            fold = up_fold_enabled() and grid >= 3
            if not fold:
                x = self._upsample(x, spatial, upsample2x_into_s2d_fast, upsample2x_into_s2d_halo)
            return self.conv_block((x, skip), s2d=True, s2d_segments_first=segments,
                                   generator=generator, spatial=spatial, up_fold_first=fold)
        exact = skip_size == (2 * size[0], 2 * size[1])
        if spatial is not None and not exact:
            raise ValueError(f"a row shard's decoder upsamples exactly 2x, not {size} to "
                             f"{skip_size}")
        fold = (exact and dense_up_fold_enabled(not self.training) and self.kernel_size == 3
                and grid >= 3)
        if exact and not fold:
            x = self._upsample(x, spatial, upsample2x_nhwc_fast, upsample2x_nhwc_halo)
        elif not exact and size != skip_size:
            x = nchw(resize_bilinear(nhwc(x), skip_size))
        return self.conv_block((x, skip), generator=generator, spatial=spatial,
                               up_fold_first=fold)

    @staticmethod
    def _upsample(x: torch.Tensor, spatial: Optional[SpatialContext], whole, halo) -> torch.Tensor:
        """The 2x upsample of the NCHW view x by K2a or K2b (``whole``), or on
        a row shard by its halo'd wrapper (``halo``)."""
        x = nhwc(x)
        if spatial is None:
            return nchw(whole(x))
        return nchw(halo(x, *halo_rows(x, spatial, repeat_edges=True)))
