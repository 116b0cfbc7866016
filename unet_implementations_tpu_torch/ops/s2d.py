"""Space-to-depth execution of a full-resolution level: the layout algebra
and the decoder's upsample folds.

Counterpart of ``unet_implementations_tpu/models/s2d.py``. A stride-1 k×k
conv commutes exactly with space-to-depth: rearrange (B, 2i+dy, 2j+dx, c)
to (B, i, j, q·C + c) with q = dy·2 + dx (q-major), and the conv becomes a
K′×K′ conv over the rearranged tensor whose (4Cout, 4Cin) kernel is the
original kernel scattered into a fixed pattern of zeros (25% dense for
k = 3). The numbers are those of the dense conv: the extra products multiply
structural zeros.

Concatenating two q-major tensors is not the s2d of their concatenation,
so the kernel transform takes ``in_segments`` and ``conv_s2d_multi`` convs
each segment separately and sums, without materializing the concat.

The upsample folds (``conv_up_fold``, ``conv_s2d_multi_up_fold``,
``conv_dense_up_fold``): a decoder's conv_0 of the 2x bilinear upsample of
x is a 3×3 conv of x itself on the coarse grid, whose kernel folds the lerp
weights in (``fold_up_kernel``), with its one-block border frame recomputed
on 3-line strips. No upsampled tensor is made. The policies
``up_fold_enabled`` and ``dense_up_fold_enabled`` read JAX's variables
``UNET_TPU_S2D_UP_FOLD`` and ``UNET_TPU_DENSE_UP_FOLD`` at each call and
default to off, as JAX decides off the TPU.

Every function takes and returns NHWC tensors, as the JAX functions do;
conv kernels are in torch's (Cout, Cin, kh, kw) layout. The convs run as
``ops/quant.py::qconv`` on NCHW views in channels_last memory: ``F.conv2d``
(cuDNN on the card), so an NHWC-contiguous input reaches cuDNN without a
copy, or the fp8 conv where the fp8 mode takes the conv.

Row shards (``parallel/spatial.py``): a conv given ``rows`` takes x already
padded with its neighbours' halo rows (K′//2 a side; the row above alone for
the stride-2 conv), pads only its columns, and shows the fp8 policy
``rows``, the whole grid's rows. The folds take a ``RowShard`` instead.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from unet_implementations_tpu_torch.ops.quant import qconv, qconv_sum
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
                              bias: torch.Tensor, rows: Optional[int] = None) -> torch.Tensor:
    """Stride-2 3×3 conv of an s2d input (B, H′, W′, 4Cin) into a DENSE
    (B, H′, W′, Cout) map: a 2×2 conv padded (1, 0) in rows and columns.

    Through ``F.conv2d`` the (1, 0) padding is done as padding 1 on both sides
    and dropping the last output row and column: one extra row and column of
    products, and no padded copy of the input; the returned NHWC view is then
    not contiguous. With ``rows`` (a row shard) x carries the row above it.
    """
    kt = transform_kernel_stride2(kernel.to(x.dtype))
    padding = (1, 0, 1, 0) if rows is None else (0, 0, 1, 0)
    return _nhwc(qconv(_nchw(x), kt, bias.to(x.dtype), 1, padding, rows))


def s2d_bias(bias: torch.Tensor) -> torch.Tensor:
    """(Cout,) -> (4Cout,) in q-major layout."""
    return bias.repeat(4)


def _same(pad: int, rows: Optional[int]):
    """A same conv's padding: ``pad`` a side, or on a row shard (``rows``),
    whose halo rows are its row padding, the columns' alone."""
    return pad if rows is None else (0, 0, pad, pad)


def halo_of(kernel_size: int) -> int:
    """The s2d rows a side that a stride-1 s2d conv of a k×k kernel reads
    beyond its output row (K′ // 2): 1 for k = 3 and 5, 0 for k = 1."""
    entries = _s2d_kernel_pattern(kernel_size)
    return -int(entries[:, 0].min())


def conv_s2d(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor],
             in_segments: Optional[Sequence[int]] = None,
             rows: Optional[int] = None) -> torch.Tensor:
    """Stride-1 same-padded conv over an s2d tensor, exact against the dense
    conv. ``kernel`` is the canonical (Cout, Cin, k, k) kernel, cast to x's
    dtype and transformed here; ``bias`` None adds none. ``rows``: x is a
    row shard with its halo rows (see the module's docstring)."""
    kt = transform_kernel(kernel.to(x.dtype), in_segments)
    b = None if bias is None else s2d_bias(bias).to(x.dtype)
    return _nhwc(qconv(_nchw(x), kt, b, 1, _same(kt.shape[-1] // 2, rows), rows))


def _segment_kernels(kernel: torch.Tensor, segments: Sequence[int]) -> list:
    """The s2d kernels of each segment's slice of ``kernel``."""
    bounds = np.cumsum((0, *segments))
    return [transform_kernel(kernel[:, lo:hi]) for lo, hi in zip(bounds[:-1], bounds[1:])]


def conv_s2d_multi(xs: Sequence[torch.Tensor], kernel: torch.Tensor, bias: torch.Tensor,
                   segments: Sequence[int], rows: Optional[int] = None) -> torch.Tensor:
    """Stride-1 s2d conv over a channel-concat of s2d tensors without
    materializing the concat: ``conv(concat(xs), K) == Σ conv(x_i, K_i)``,
    with ``K_i`` the kernel's slice of segment i (``qconv_sum``). ``rows``:
    each x is a row shard with its halo rows."""
    if len(xs) != len(segments):
        raise ValueError(f"{len(xs)} inputs for {len(segments)} segments")
    kts = _segment_kernels(kernel.to(xs[0].dtype), segments)
    y = qconv_sum([_nchw(x) for x in xs], kts, s2d_bias(bias).to(xs[0].dtype), 1,
                  _same(kts[0].shape[-1] // 2, rows), rows)
    return _nhwc(y)


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


# --- The upsample folds -------------------------------------------------------
#
# For output sub-pixel parity o and original kernel tap k, a 3×3 conv of the
# 2x upsample reads upsampled row n = o + k - 1, the two-tap lerp of x's rows;
# _FOLD_TAPS[o, k, dy + 1] is its weight on x's row offset dy ∈ {-1, 0, 1}:
#     n = 2·by + ry;  ry = 0 -> {x[by - 1]: 0.25, x[by]: 0.75}
#                     ry = 1 -> {x[by]: 0.75, x[by + 1]: 0.25}
_FOLD_TAPS = np.zeros((2, 3, 3), np.float64)
for _o in range(2):
    for _k in range(3):
        _by, _ry = (_o + _k - 1) // 2, (_o + _k - 1) % 2
        if _ry == 0:
            _FOLD_TAPS[_o, _k, _by] += 0.25
            _FOLD_TAPS[_o, _k, _by + 1] += 0.75
        else:
            _FOLD_TAPS[_o, _k, _by + 1] += 0.75
            _FOLD_TAPS[_o, _k, _by + 2] += 0.25
del _o, _k, _by, _ry

# The taps as a tensor on a device (float64), made once per device; while
# ``torch.export`` traces, made anew (see ``_on_device``).
_DEVICE_TAPS: dict = {}


def _taps(device: torch.device) -> torch.Tensor:
    if torch.compiler.is_compiling():
        return torch.tensor(_FOLD_TAPS, device=device)
    taps = _DEVICE_TAPS.get(device)
    if taps is None:
        with torch.inference_mode(False):
            taps = _DEVICE_TAPS[device] = torch.tensor(_FOLD_TAPS, device=device)
    return taps


def fold_up_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, 3, 3) -> (4Cout, Cin, 3, 3), the q-major composite kernel:
    output channel (oy·2 + ox)·Cout + o.

    ``conv_s2d(upsample2x_into_s2d(x), K)`` is, away from the border frame, a
    plain 3×3 conv of the pre-upsample x by this kernel: the four q groups of
    the upsample are lerps of the same Cin channels, so the lerp weights fold
    into the kernel. As JAX's einsum does, the fold contracts over the rows'
    taps and then over the columns', each sum exact (float64) and rounded once
    to the kernel's dtype: JAX casts the kernel to the activation's dtype
    first, and so do the callers here.
    """
    cout, cin, kh, kw = kernel.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"fold_up_kernel takes a 3x3 kernel, got {kh}x{kw}")
    taps = _taps(kernel.device)
    # (o, c, ky, kx) with (oy, ky, dy) -> (o, c, kx, oy, dy), rounded.
    rows = torch.einsum("ocyx,pyd->ocxpd", kernel.double(), taps).to(kernel.dtype)
    # with (ox, kx, dx) -> (o, c, oy, dy, ox, dx), rounded.
    kf = torch.einsum("ocxpd,qxe->ocpdqe", rows.double(), taps).to(kernel.dtype)
    return kf.permute(2, 4, 0, 1, 3, 5).reshape(4 * cout, cin, 3, 3)


class RowShard(NamedTuple):
    """A fold's row shard: its input x carries one neighbour row on each side
    that is not the grid's edge. ``rows``: the whole coarse grid's rows;
    ``first`` and ``last``: whether x holds its top and bottom rows."""

    rows: int
    first: bool
    last: bool


def _up_contrib_strip(x3: torch.Tensor, kt: torch.Tensor, axis: int, last: bool,
                      rows: Optional[int] = None) -> torch.Tensor:
    """The up-segment's contribution to one border line of the s2d output,
    by the reference path: ``x3``, up to 3 rows (``axis=1``) or columns
    (``axis=2``) at an edge of the pre-upsample tensor, upsampled (plain, in
    x's dtype), then the s2d conv by ``kt`` (``transform_kernel`` of the
    segment's kernel) padded (1, 1) on both axes, and its first or
    (``last``) last line kept. The slice's far-edge clamp is wrong for the
    whole tensor, but the kept line reads none of it. ``rows``: the grid the
    fp8 policy sees (JAX's strip is a 3-line slice of the whole tensor)."""
    up = upsample2x_into_s2d(x3)
    y = _nhwc(qconv(_nchw(up), kt, None, 1, 1, rows))
    return y.narrow(axis, y.shape[axis] - 1 if last else 0, 1)


def _up_fold(x: torch.Tensor, kernel: torch.Tensor, shard: Optional[RowShard]) -> torch.Tensor:
    """``conv_up_fold`` of x, or of a ``RowShard``'s rows: the interior's
    folded conv, the border frame's strips written into one copy of it (out
    of place: autograd records the copy and the slice writes), the neighbour
    rows' outputs dropped."""
    b, h, w, _ = x.shape
    kernel = kernel.to(x.dtype)
    grid = None if shard is None else shard.rows
    first, last = (True, True) if shard is None else (shard.first, shard.last)
    y = _nhwc(qconv(_nchw(x), fold_up_kernel(kernel), None, 1, 1, grid))
    # The strips' s2d kernel, made once. Column strips take every row of x
    # (exact in each row a shard keeps) and the corners, as JAX writes them
    # last.
    kt = transform_kernel(kernel)
    out = y.clone()
    if first:
        out[:, :1] = _up_contrib_strip(x[:, :3], kt, 1, False, 3)
    if last:
        out[:, h - 1:] = _up_contrib_strip(x[:, max(h - 3, 0):], kt, 1, True, 3)
    out[:, :, :1] = _up_contrib_strip(x[:, :, :3], kt, 2, False, grid)
    out[:, :, w - 1:] = _up_contrib_strip(x[:, :, w - 3:], kt, 2, True, grid)
    return out[:, 0 if first else 1:h if last else h - 1]


def conv_up_fold(x: torch.Tensor, kernel: torch.Tensor,
                 shard: Optional[RowShard] = None) -> torch.Tensor:
    """The up-segment of an s2d decoder conv, computed without upsampling.

    ``x``: the pre-upsample dense tensor (B, H, W, Cin), on the s2d level's
    grid; ``kernel``: (Cout, Cin, 3, 3). Returns the (B, H, W, 4Cout) s2d
    contribution of ``conv_s2d(upsample2x_into_s2d(x), K)``, without bias.

    Interior: one folded 3×3 conv (``fold_up_kernel``). Border: the fold's
    zero padding is not the composite's (the upsample clamps its lerps at
    the edge, then the s2d conv zero-pads a whole block), so the one-block
    frame is recomputed by the reference path on 3-line strips.

    ``shard``: x is a row shard with a neighbour row beyond each edge that is
    not the grid's; output block row r reads x's rows r−1…r+1 only, so the
    folded conv and the column strips are exact on the shard's rows, and
    the row strips run only at the grid's edges. Returns the shard's rows.
    """
    b, h, w, _ = x.shape
    grid_h = h if shard is None else shard.rows
    if grid_h < 3 or w < 3:
        raise ValueError(
            f"conv_up_fold needs a >=3x3 coarse grid for its border-strip recompute (got "
            f"{grid_h}x{w}); callers must fall back to the reference upsample path below that.")
    return _up_fold(x, kernel, shard)


def up_fold_enabled() -> bool:
    """Whether an s2d decoder folds its upsample into conv_0
    (``conv_s2d_multi_up_fold``): ``UNET_TPU_S2D_UP_FOLD``, JAX's variable
    and parsing ("0", "false" and "" are off, anything else on), read at each
    call. Unset: off, as JAX decides off the TPU; whether the card should
    fold by default is for its benchmark to decide."""
    v = os.environ.get("UNET_TPU_S2D_UP_FOLD")
    return v is not None and v not in ("0", "false", "")


def dense_up_fold_enabled(deterministic: bool = True) -> bool:
    """Whether a dense decoder folds its upsample into conv_0
    (``conv_dense_up_fold``): ``UNET_TPU_DENSE_UP_FOLD`` forces both modes;
    unset, the eval forward (``deterministic``) follows ``up_fold_enabled``
    and training does not fold, as JAX's per-mode policy."""
    v = os.environ.get("UNET_TPU_DENSE_UP_FOLD")
    if v is not None:
        return v not in ("0", "false", "")
    return deterministic and up_fold_enabled()


def conv_s2d_multi_up_fold(x_pre_up: torch.Tensor, rest: Sequence[torch.Tensor],
                           kernel: torch.Tensor, bias: torch.Tensor, segments: Sequence[int],
                           shard: Optional[RowShard] = None) -> torch.Tensor:
    """``conv_s2d_multi([upsample2x_into_s2d(x_pre_up), *rest], ...)`` with
    the upsample folded into segment 0's kernel (``conv_up_fold``); the rest
    (s2d tensors) add their convs, then the bias, in JAX's order. ``shard``:
    x_pre_up as ``conv_up_fold`` takes it, each of ``rest`` with its halo
    rows."""
    if len(rest) != len(segments) - 1:
        raise ValueError(f"{1 + len(rest)} inputs for {len(segments)} segments")
    kernel = kernel.to(x_pre_up.dtype)
    y = conv_up_fold(x_pre_up, kernel[:, :segments[0]], shard)
    kts = _segment_kernels(kernel[:, segments[0]:], segments[1:])
    rows = None if shard is None else shard.rows
    out = qconv_sum([_nchw(x) for x in rest], kts, s2d_bias(bias).to(y.dtype), 1,
                    _same(1, rows), rows, residual=_nchw(y))
    return _nhwc(out)


def conv_dense_up_fold(x_pre_up: torch.Tensor, rest: Sequence[torch.Tensor],
                       kernel: torch.Tensor, bias: torch.Tensor,
                       shard: Optional[RowShard] = None) -> torch.Tensor:
    """A dense decoder's conv_0, ``conv(concat([upsample2x_nhwc(x_pre_up),
    *rest]), K) + bias``, with the upsample folded away: segment 0 runs as
    ``conv_up_fold`` on the coarse grid (as many products as the dense conv
    of the upsample) and is rearranged once (``depth_to_space``); the rest
    (dense, on the fine grid) add their 3×3 convs, then the bias. ``shard``:
    as ``conv_s2d_multi_up_fold``'s, ``rest`` padded with one halo row a
    side."""
    kernel = kernel.to(x_pre_up.dtype)
    c0 = x_pre_up.shape[-1]
    y = depth_to_space(conv_up_fold(x_pre_up, kernel[:, :c0], shard))
    weights = kernel[:, c0:].split([x.shape[-1] for x in rest], dim=1)
    rows = None if shard is None else 2 * shard.rows
    out = qconv_sum([_nchw(x) for x in rest], weights, bias.to(y.dtype), 1, _same(1, rows), rows,
                    residual=_nchw(y))
    return _nhwc(out)
