"""Space-to-depth execution of a full-resolution level: the layout algebra.

Counterpart of ``unet_implementations_tpu/models/s2d.py``, without the
upsample folds. A stride-1 k×k conv commutes exactly with space-to-depth:
rearrange (B, 2i+dy, 2j+dx, c) to (B, i, j, q·C + c) with q = dy·2 + dx
(q-major), and the conv becomes a K′×K′ conv over the rearranged tensor
whose (4Cout, 4Cin) kernel is the original kernel scattered into a fixed
pattern of zeros (25% dense for k = 3). The numbers are those of the dense
conv: the extra products multiply structural zeros.

Concatenating two q-major tensors is not the s2d of their concatenation,
so the kernel transform takes ``in_segments`` and ``conv_s2d_multi`` convs
each segment separately and sums, without materializing the concat.

Every function takes and returns NHWC tensors, as the JAX functions do;
conv kernels are in torch's (Cout, Cin, kh, kw) layout. The convs run as
``F.conv2d`` on NCHW views in channels_last memory (cuDNN on the card), so
an NHWC-contiguous input reaches cuDNN without a copy.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from unet_implementations_tpu_torch.ops.resize import lerp2_taps


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def space_to_depth(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/f, W/f, f²·C), q-major channel layout."""
    b, h, w, c = x.shape
    f = factor
    x = x.reshape(b, h // f, f, w // f, f, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // f, w // f, f * f * c)


def depth_to_space(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Inverse of ``space_to_depth`` (q-major layout)."""
    b, hp, wp, cf = x.shape
    f = factor
    c = cf // (f * f)
    x = x.reshape(b, hp, wp, f, f, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp * f, wp * f, c)


def _s2d_kernel_pattern(k: int) -> np.ndarray:
    """Static scatter pattern: rows (by, bx, ry, rx, oy, ox, ky, kx).

    For output sub-pixel (oy, ox) and original tap (ky, kx), the source row
    is n = oy + ky - k//2; written as n = 2·by + ry, the tap lands at block
    offset by ∈ {-1, 0, 1} and input sub-pixel ry.
    """
    pad = k // 2
    entries = []
    for oy in range(2):
        for ox in range(2):
            for ky in range(k):
                for kx in range(k):
                    ny, nx = oy + ky - pad, ox + kx - pad
                    entries.append((ny // 2, nx // 2, ny % 2, nx % 2, oy, ox, ky, kx))
    return np.asarray(entries, np.int64)


# (index, inverse) pairs on a device, by (transform, shape, device).
_DEVICE_INDICES: dict = {}


def _on_device(key: tuple, build, device: torch.device) -> tuple:
    """``_cached_index(*build())`` on ``device``, made once per key and
    device; while ``torch.export`` traces (``torch.compiler.is_compiling``)
    made anew and not kept, since a tensor made then is a constant of the
    traced program, not a tensor to reuse."""
    if torch.compiler.is_compiling():
        return _cached_index(*build(), device)
    out = _DEVICE_INDICES.get((key, device))
    if out is None:
        out = _DEVICE_INDICES[(key, device)] = _cached_index(*build(), device)
    return out


def _transform_index(k: int, cout: int, segments: tuple, device: torch.device) -> tuple:
    """Flat indices into ``[kernel.flatten(), 0]`` that build the transformed
    (4Cout, 4Cin, K′, K′) kernel (index ``kernel.numel()`` is the zero), and
    their inverse (``_cached_index``). Built once per shape and device."""
    return _on_device(("stride1", k, cout, segments),
                      lambda: _transform_index_np(k, cout, segments), device)


@functools.lru_cache(maxsize=None)
def _transform_index_np(k: int, cout: int, segments: tuple) -> tuple:
    cin = sum(segments)
    entries = _s2d_kernel_pattern(k)
    b_lo = int(entries[:, :2].min())
    kp = int(entries[:, :2].max()) - b_lo + 1
    zero = cout * cin * k * k
    idx = np.full((4 * cout, 4 * cin, kp, kp), zero, np.int64)
    co = np.arange(cout)[:, None]
    for by, bx, ry, rx, oy, ox, ky, kx in entries:
        qin, qout = ry * 2 + rx, oy * 2 + ox
        base = 0
        for cs in segments:
            ci = np.arange(base, base + cs)[None, :]
            idx[qout * cout:(qout + 1) * cout,
                4 * base + qin * cs:4 * base + (qin + 1) * cs,
                by - b_lo, bx - b_lo] = ((co * cin + ci) * k + ky) * k + kx
            base += cs
    return idx, cout * cin * k * k


def _stride2_index(cout: int, cin: int, device: torch.device) -> tuple:
    """As ``_transform_index``, for ``transform_kernel_stride2``."""
    return _on_device(("stride2", cout, cin), lambda: _stride2_index_np(cout, cin), device)


@functools.lru_cache(maxsize=None)
def _stride2_index_np(cout: int, cin: int) -> tuple:
    idx = np.full((cout, 4 * cin, 2, 2), cout * cin * 9, np.int64)
    co, ci = np.arange(cout)[:, None], np.arange(cin)[None, :]
    for ky in range(3):
        for kx in range(3):
            ny, nx = ky - 1, kx - 1
            qin = (ny % 2) * 2 + nx % 2
            idx[:, qin * cin:(qin + 1) * cin, ny // 2 + 1, nx // 2 + 1] = \
                ((co * cin + ci) * 3 + ky) * 3 + kx
    return idx, cout * cin * 9


def _cached_index(idx: np.ndarray, n_sources: int, device: torch.device) -> tuple:
    """(index, inverse) on ``device``: ``inverse[s]`` lists the flat
    positions of ``idx`` that hold source element s, which every source
    fills equally often (4 times in the stride-1 transform, once in the
    stride-2 one). Built as normal tensors even under
    ``torch.inference_mode``, so that a later training forward may save them
    for backward."""
    flat = idx.reshape(-1)
    order = np.argsort(flat, kind="stable")[:int((flat < n_sources).sum())]
    inverse = order.reshape(n_sources, -1)
    if not (flat[inverse] == np.arange(n_sources)[:, None]).all():
        raise AssertionError("a source element fills an uneven number of positions")
    with torch.inference_mode(False):
        return torch.from_numpy(idx).to(device), torch.from_numpy(inverse).to(device)


class _Gather(torch.autograd.Function):
    """``[kernel.flatten(), 0][index]``; its backward gathers each source
    element's positions through the inverse index and sums them, where the
    autograd of the indexing would scatter-add, every zero position into one
    element (slow on the card)."""

    @staticmethod
    def forward(ctx, kernel, index, inverse):
        ctx.save_for_backward(inverse)
        ctx.shape = kernel.shape
        return torch.cat([kernel.reshape(-1), kernel.new_zeros(1)])[index]

    @staticmethod
    def backward(ctx, grad):
        (inverse,) = ctx.saved_tensors
        return grad.reshape(-1)[inverse].sum(dim=-1).reshape(ctx.shape), None, None


def _gather(kernel: torch.Tensor, indices: tuple) -> torch.Tensor:
    """A scatter into zeros written as one gather, exact in every dtype."""
    return _Gather.apply(kernel, *indices)


def transform_kernel(kernel: torch.Tensor,
                     in_segments: Optional[Sequence[int]] = None) -> torch.Tensor:
    """(Cout, Cin, k, k) -> (4Cout, 4Cin, K′, K′), the s2d-equivalent kernel.

    K′ is the number of distinct block offsets: 3 for k = 3, 1 for k = 1.
    ``in_segments`` (dense channel counts summing to Cin) describes an input
    that is a channel-concat of separately rearranged tensors: the s2d
    channel of (segment s, sub-pixel q, local channel c) is
    ``4·sum(segments[:s]) + q·segments[s] + c``. Default: one segment.
    """
    cout, cin, k, _ = kernel.shape
    segments = tuple(in_segments) if in_segments is not None else (cin,)
    if sum(segments) != cin:
        raise ValueError(f"segments {segments} do not sum to Cin = {cin}")
    return _gather(kernel, _transform_index(k, cout, segments, kernel.device))


def transform_kernel_stride2(kernel: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, 3, 3) stride-2 kernel -> (Cout, 4Cin, 2, 2) for an s2d input.

    Output pixel (i, j) of the stride-2 conv reads rows n = ky - 1 ∈ {-1, 0, 1}
    = 2·by + ry with by ∈ {-1, 0}: a 2×2 conv over blocks, padded (1, 0),
    whose output is dense at the half resolution.
    """
    cout, cin, kh, kw = kernel.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"transform_kernel_stride2 takes a 3x3 kernel, got {kh}x{kw}")
    return _gather(kernel, _stride2_index(cout, cin, kernel.device))


def conv_s2d_to_dense_stride2(x: torch.Tensor, kernel: torch.Tensor,
                              bias: torch.Tensor) -> torch.Tensor:
    """Stride-2 3×3 conv of an s2d input (B, H′, W′, 4Cin) into a DENSE
    (B, H′, W′, Cout) map.

    The (1, 0) padding is done as padding 1 on both sides and dropping the
    last output row and column: one extra row and column of products, and
    no padded copy of the input. The returned NHWC view is not contiguous.
    """
    kt = transform_kernel_stride2(kernel.to(x.dtype))
    y = F.conv2d(_nchw(x), kt, bias.to(x.dtype), padding=1)
    return _nhwc(y)[:, :x.shape[1], :x.shape[2]]


def s2d_bias(bias: torch.Tensor) -> torch.Tensor:
    """(Cout,) -> (4Cout,) in q-major layout."""
    return bias.repeat(4)


def conv_s2d(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor],
             in_segments: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Stride-1 same-padded conv over an s2d tensor, exact against the dense
    conv. ``kernel`` is the canonical (Cout, Cin, k, k) kernel, cast to x's
    dtype and transformed here; ``bias`` None adds none."""
    kt = transform_kernel(kernel.to(x.dtype), in_segments)
    b = None if bias is None else s2d_bias(bias).to(x.dtype)
    return _nhwc(F.conv2d(_nchw(x), kt, b, padding=kt.shape[-1] // 2))


def conv_s2d_multi(xs: Sequence[torch.Tensor], kernel: torch.Tensor, bias: torch.Tensor,
                   segments: Sequence[int]) -> torch.Tensor:
    """Stride-1 s2d conv over a channel-concat of s2d tensors without
    materializing the concat: ``conv(concat(xs), K) == Σ conv(x_i, K_i)``,
    with ``K_i`` the kernel's slice of segment i. The bias goes with the
    first segment's conv; the others are added into its output in place."""
    if len(xs) != len(segments):
        raise ValueError(f"{len(xs)} inputs for {len(segments)} segments")
    y, base = None, 0
    for i, (x, cs) in enumerate(zip(xs, segments)):
        yi = conv_s2d(x, kernel[:, base:base + cs], bias if i == 0 else None)
        y = yi if y is None else y.add_(yi)
        base += cs
    return y


def instance_norm_s2d(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                      eps: float = 1e-5, out_dtype=None) -> torch.Tensor:
    """InstanceNorm of an s2d tensor with per-ORIGINAL-channel statistics:
    channel c pools its 4 sub-pixels, as dense InstanceNorm over the full
    resolution does. Float32 single-pass statistics, biased variance."""
    b, hp, wp, cf = x.shape
    c = cf // 4
    xf = x.to(torch.float32).reshape(b, hp, wp, 4, c)
    n = hp * wp * 4
    s1 = xf.sum(dim=(1, 2, 3), keepdim=True)
    s2 = (xf * xf).sum(dim=(1, 2, 3), keepdim=True)
    mean = s1 / n
    var = torch.clamp(s2 / n - mean * mean, min=0.0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * scale.to(torch.float32) + bias.to(torch.float32)
    return y.reshape(b, hp, wp, cf).to(out_dtype or x.dtype)


def upsample2x_into_s2d(x: torch.Tensor) -> torch.Tensor:
    """Exact 2x bilinear upsample emitted directly in s2d layout: (B, H, W, C)
    -> (B, H, W, 4C) = s2d(upsample2x(x)). The plain version of K2b.

    Each sub-pixel is the two-tap lerp of ``ops.resize.lerp2_taps`` (float32,
    rounded to the input dtype after each axis, H first); in q-major layout
    the four phases are a channel concat, in q order (0,0), (0,1), (1,0), (1,1).
    """
    row0, row1 = lerp2_taps(x, 1)
    c00, c01 = lerp2_taps(row0, 2)
    c10, c11 = lerp2_taps(row1, 2)
    return torch.cat([c00, c01, c10, c11], dim=-1)
