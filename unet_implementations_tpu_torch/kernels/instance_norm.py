"""K1: fused InstanceNorm + LeakyReLU, forward and backward (CUDA,
``csrc/instance_norm.cu``).

The forward replaces ``unet_implementations_tpu/kernels/instance_norm.py::
_pallas_forward`` (``_stats_kernel`` and ``_normalize_kernel``); the backward
is the counterpart of that module's ``custom_vjp`` backward ``_bwd_impl``. It
follows every block conv of the UNet: 22 calls per forward of the 6-stage
model, and 22 backward calls per train step.

``y = lrelu((x - mean) * rstd * scale + bias)`` per (image, channel) over
H*W, with float32 sums, biased variance, and ``y`` computed in float32 and
rounded once to x's dtype. With ``group=4`` the statistics pool the four
q-major sub-pixel blocks of a space-to-depth tensor (channel = q*Cg + c).

Bound: bytes. The forward must read x once and write y once, the backward
read x and dy once and write dx once. The forward reads x twice (statistics,
then output), so it can reach at best 2/3 of its bound. The backward is one
persistent cooperative launch that holds what it reads in shared memory
until its statistics are out, so it reads x and dy once, for every shape
whose (image, slice) pairs fit at least two to a round of the card's blocks;
the larger shapes (levels 0 and 1 of the 6-stage model at 512²) take the
two-pass backward, which reads them twice (``bwd_plan`` says which, and
why). See the source for the designs.

Spatial partitioning (``parallel/spatial.py``) spreads an image's rows over
the ranks of a ``space_group``. Then each image's statistics are those of
all its rows: the forward runs its statistics pass without the finalize,
all-reduces the float32 partials over the group, finalizes with the whole
image's pixel count and applies; the backward takes the two-pass kernel
whatever the shape (the one-read kernel cannot pause between its statistics
and its apply) and all-reduces each image's Σdpre and Σ(dpre·xhat) between
its two passes. ``dscale`` and ``dbias`` stay the rank's own rows' sums, so
that the gradient reduction over the ranks counts each row once. Without a
group nothing changes: one forward launch, and ``bwd_plan``'s choice.

On CPU tensors ``fused_instance_norm`` runs the plain versions
``_torch_forward`` and ``_torch_backward``; on CUDA tensors it launches the
kernels or raises. ``_torch_backward`` is the JAX ``_bwd_impl`` in plain torch
ops: from the saved x, mean and rstd it returns dx in x's dtype and
``dscale``/``dbias`` pooled over the batch (and the 4 q blocks with
``group=4``). The kernel computes the same in a factored form (its partial
sums are of ``dpre`` and ``dpre * xhat``, multiplied by ``scale`` once per
channel), which differs from the plain version by float32 rounding only.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.distributed as dist

from unet_implementations_tpu_torch.kernels import _build

# A block covers one chunk of an image's pixels: an image is cut into at most
# _MAX_CHUNKS chunks of at least _MIN_CHUNK_BYTES of x. The chunks depend on
# the image's shape alone, so an image's result does not depend on its batch.
_MAX_CHUNKS = 32
_MIN_CHUNK_BYTES = 64 * 1024
# ``passes`` of the forward entry point and of the two-pass backward's: the
# first pass, the second, or both.
STATS, APPLY, BOTH = 1, 2, 3

_FWD_ARGTYPES = [ctypes.c_void_p] * 8 + [
    ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
]
_BWD_ARGTYPES = [ctypes.c_void_p] * 12 + [
    ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, *[ctypes.c_int] * 9, ctypes.c_uint,
    ctypes.c_float, ctypes.c_void_p,
]
_TWO_PASS_ARGTYPES = [ctypes.c_void_p] * 12 + [
    ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
]
_PARTIALS_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p]
_FINALIZE_ARGTYPES = [ctypes.c_void_p] * 3 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
    ctypes.c_void_p,
]
# The backward kernel (csrc/instance_norm.cu::in_bwd_fused_kernel): compute
# threads a block at most (three role warps join them), the least bytes a
# slice takes of each q block of a
# pixel (one DRAM sector) and the least that DRAM reads at its full rate, the
# ring's steps at most, the buffers of a block's sums (the compute threads
# reduce up to one piece ahead), and shared memory left for static variables.
_BWD_THREADS = 416
_SECTOR_BYTES = 32
_SEGMENT_BYTES = 64
_MAX_RING_STEPS = 32
_BUFFERS = 2
# The fused kernel takes a shape when a round of the card's blocks holds at
# least this many of its (image, slice) pairs; measured on an H100 (PERF.md).
_PAIRS_A_ROUND = 4
_BWD_SMEM_RESERVE = 1024


def chunking(hw: int, c: int, itemsize: int) -> tuple[int, int]:
    """(pixels per block, blocks per image) of both kernels' passes."""
    chunk_px = max(-(-hw // _MAX_CHUNKS), _MIN_CHUNK_BYTES // (c * itemsize), 1)
    chunk_px = min(chunk_px, hw)
    return chunk_px, -(-hw // chunk_px)


class BwdPlan(NamedTuple):
    """How one backward call cuts its work (``csrc/instance_norm.cu``): an
    (image, slice) pair is ``parts`` pieces of ``part_px`` pixels; piece ``g``
    is part ``g % parts`` of pair ``g // parts``, pair ``img * nslices + j``
    holds original channels ``[j * cs, (j + 1) * cs)`` of every q block, and
    block ``k`` takes pieces ``k, k + grid, ...`` in order."""

    vec: int           # elements a vector: 16 bytes' worth, or 1
    cs: int            # original channels a slice
    nslices: int       # slices an image: C / group / cs
    nv: int            # vectors of a slice's pixel: group * cs / vec
    rows: int          # pixel rows a step of a block covers
    threads: int       # compute threads, rows * nv (and one sync warp)
    parts: int         # pieces a pair
    part_px: int       # pixels a piece (the pair's last may hold fewer)
    steps: int         # steps of a full piece
    ring_steps: int    # steps the block's shared-memory ring holds
    grid: int          # blocks: one a SM, at most one a piece
    smem: int          # dynamic shared memory of a block, bytes
    pieces: int        # b * nslices * parts
    reread_bytes: int  # bytes of x and dy read a second time
    fused: bool        # the one-read kernel; else the two-pass one (see bwd_plan)


@functools.lru_cache(maxsize=256)
def bwd_plan(b: int, hw: int, c: int, group: int, itemsize: int, n_blocks: int,
             smem_per_block: int, vec: int | None = None, split: bool = False) -> BwdPlan:
    """The backward kernel's plan for x of (b, hw, c) with ``itemsize``-byte
    elements, on a card of ``n_blocks`` SMs whose blocks may take
    ``smem_per_block`` bytes of shared memory. ``vec``, the elements of a
    compute thread's vector, is 16 bytes' worth when C allows (the default),
    and 1 when a pointer is not 16-byte aligned.

    A slice takes at least 64 bytes of each q block of a pixel, which DRAM
    reads at its full rate (32 bytes of every 64 read at half of it), unless
    then fewer than _PAIRS_A_ROUND pairs fit a round: then 32 bytes (a
    sector), whose copies fetch the whole 64-byte segment into L2 for the next
    slice. A pair
    is cut into as few pieces as let the ring hold three of them (one being
    applied, one reduced and waiting for its pair, one loading), a number that
    divides ``n_blocks``, so that each round of ``n_blocks`` pieces holds whole
    pairs. Neither depends on b.

    A shape whose round holds fewer than _PAIRS_A_ROUND pairs even so (levels
    0 and 1 of the 6-stage model at 512², and its s2d norms) takes the
    two-pass kernel instead, which reads x and dy twice (``reread_bytes``):
    there the fused kernel's pieces wait on a pair spread over most of the
    card, and on an H100 it was measured slower (PERF.md). So does every
    shape with ``split``, when an image's rows are spread over processes: the
    two-pass kernel can pause between its passes for their sums to be added
    up, the fused one cannot."""
    cg = c // group
    if vec is None:
        vec = 16 // itemsize if c % (16 // itemsize) == 0 else 1
    if split:
        return BwdPlan(vec, *[0] * 12, 2 * b * hw * c * itemsize, False)

    def takes(d):  # a slice of d channels the kernel's layout takes
        nv = group * d // vec
        return d % vec == 0 and math.lcm(nv, 32) <= _BWD_THREADS

    layouts = [d for d in range(1, cg + 1) if cg % d == 0 and takes(d)]
    plans = [p for p in (_bwd_plan(b, hw, c, group, itemsize, n_blocks, smem_per_block, vec, d)
                         for d in layouts) if p is not None]
    if layouts and not plans:
        raise ValueError(f"fused_instance_norm backward: {smem_per_block} bytes of shared "
                         f"memory hold no step of any slice of {cg} channels")
    if not plans:  # no slice fits the fused kernel's layout: the two-pass one
        return BwdPlan(vec, *[0] * 12, 2 * b * hw * c * itemsize, False)
    sector = [p for p in plans if p.cs * itemsize >= _SECTOR_BYTES]
    if not sector:  # fewer channels than a sector: the widest slice
        plan = max(plans, key=lambda p: p.cs)
    else:  # fused; then 64 bytes or more; then the narrowest
        plan = min(sector, key=lambda p: (not p.fused, p.cs * itemsize < _SEGMENT_BYTES, p.cs))
    return plan if plan.fused else plan._replace(reread_bytes=2 * b * hw * c * itemsize)


def _bwd_plan(b, hw, c, group, itemsize, n_blocks, smem_per_block, vec, cs) -> BwdPlan | None:
    nv = group * cs // vec
    ne = nv * vec
    unit = math.lcm(32, nv)  # whole warps of whole pixel rows
    threads = _BWD_THREADS // unit * unit
    rows = threads // nv
    shfl = 32 % nv == 0  # sums by butterflies within a warp
    groups = threads // 32 if shfl else rows
    width = cs if shfl else ne
    scratch = 16 * _MAX_RING_STEPS + 4 * _BUFFERS * 2 * (groups * width + cs)
    step_bytes = 2 * threads * vec * itemsize
    ring_steps = min(_MAX_RING_STEPS,
                     (smem_per_block - _BWD_SMEM_RESERVE - scratch) // step_bytes)
    if ring_steps < 1:  # shared memory holds no step
        return None
    needed = -(-(-(-hw // rows)) // max(1, ring_steps // 3))
    parts = min(hw, next((d for d in range(needed, n_blocks + 1) if n_blocks % d == 0),
                         n_blocks))
    part_px = -(-hw // parts)
    parts = -(-hw // part_px)
    steps = -(-part_px // rows)
    nslices = c // group // cs
    pieces = b * nslices * parts
    return BwdPlan(vec, cs, nslices, nv, rows, threads, parts, part_px, steps, ring_steps,
                   min(n_blocks, pieces), ring_steps * step_bytes + scratch, pieces, 0,
                   _PAIRS_A_ROUND * parts <= n_blocks and steps <= ring_steps)


def bwd_pieces(plan: BwdPlan, b: int, hw: int, block: int) -> list:
    """(image, slice, part, first pixel, end pixel) of each piece that
    ``block`` takes, in its order."""
    out = []
    for g in range(block, plan.pieces, plan.grid):
        pair, part = divmod(g, plan.parts)
        img, j = divmod(pair, plan.nslices)
        p0 = part * plan.part_px
        out.append((img, j, part, p0, min(p0 + plan.part_px, hw)))
    return out


def _space_sum(t: torch.Tensor, space_group) -> torch.Tensor:
    """``t`` summed over the ranks of ``space_group`` (in place), or ``t``
    without one."""
    if space_group is not None:
        dist.all_reduce(t, group=space_group)
    return t


def _space_size(space_group) -> int:
    return 1 if space_group is None else dist.get_world_size(space_group)


def _torch_forward(x, scale_c, bias_c, eps, negative_slope, group, space_group=None):
    """Plain version: the op sequence of the JAX ``_jnp_forward``.

    x: (B, H, W, C); scale_c, bias_c: (C // group,) float32. With a
    ``space_group`` the sums are all-reduced over its ranks (each holding
    equal row shards of the images) before the mean and variance.
    Returns (y in x.dtype, mean (B, C), rstd (B, C)).
    """
    b, h, w, c = x.shape
    xf = x.to(torch.float32)
    if group > 1:
        xg = xf.reshape(b, h, w, group, c // group)  # q-major sub-pixel axis
        n = h * w * group
        s1 = xg.sum(dim=(1, 2, 3))
        s2 = (xg * xg).sum(dim=(1, 2, 3))
    else:
        n = h * w
        s1 = xf.sum(dim=(1, 2))
        s2 = (xf * xf).sum(dim=(1, 2))
    if space_group is not None:
        s1, s2 = _space_sum(torch.stack([s1, s2]), space_group)
        n *= _space_size(space_group)
    mean_g = s1 / n
    var_g = torch.clamp(s2 / n - mean_g * mean_g, min=0.0)
    rstd_g = torch.rsqrt(var_g + eps)
    mean = mean_g.repeat(1, group)
    rstd = rstd_g.repeat(1, group)
    scale_full = scale_c.to(torch.float32).repeat(group)
    bias_full = bias_c.to(torch.float32).repeat(group)
    y = (xf - mean[:, None, None, :]) * rstd[:, None, None, :]
    y = y * scale_full + bias_full
    y = torch.where(y >= 0, y, y * negative_slope).to(x.dtype)
    return y, mean, rstd


def _check(name, x, scale_c, bias_c, group):
    """What both kernels refuse, before any launch."""
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {x.dtype}")
    c = x.shape[-1]
    if group < 1 or c % group or scale_c.shape != (c // group,) or bias_c.shape != (c // group,):
        raise ValueError(
            f"{name}: scale/bias must have C/group = {c}/{group} entries, got "
            f"{tuple(scale_c.shape)} and {tuple(bias_c.shape)}")


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def forward_buffers(x: torch.Tensor) -> tuple:
    """(y, partials, count, mean, rstd) for a forward of x (contiguous)."""
    b, h, w, c = x.shape
    nchunk = chunking(h * w, c, x.element_size())[1]
    f32 = dict(dtype=torch.float32, device=x.device)
    return (torch.empty_like(x), torch.empty((b, nchunk, 2, c), **f32),
            torch.empty(b, dtype=torch.int32, device=x.device),
            torch.empty((b, c), **f32), torch.empty((b, c), **f32))


def launch_forward(x, scale_c, bias_c, buffers, eps, negative_slope, group, passes=BOTH):
    """One call of the forward entry point on ``forward_buffers(x)``:
    ``passes`` STATS or APPLY alone time the two passes. Counts nothing."""
    b, h, w, c = x.shape
    chunk_px, nchunk = chunking(h * w, c, x.element_size())
    fn = _build.kernel_function("unet_instance_norm_fwd", _FWD_ARGTYPES)
    y, partials, count, mean, rstd = buffers
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), y.data_ptr(), scale_c.data_ptr(), bias_c.data_ptr(),
                  partials.data_ptr(), count.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                  _build.DTYPE_CODES[x.dtype], b, h * w, c, group, chunk_px, nchunk, eps,
                  negative_slope, passes, _build.stream_of(x))
    _build.check(code, "unet_instance_norm_fwd")


def launch_split_forward(x, scale_c, bias_c, buffers, eps, negative_slope, group,
                         space_group):
    """The forward of row shards whose images ``space_group``'s ranks share,
    on ``forward_buffers(x)``: the statistics pass without its finalize, the
    partials all-reduced over the group, the finalize with the whole image's
    pixel count, the apply pass. Counts nothing."""
    b, h, w, c = x.shape
    chunk_px, nchunk = chunking(h * w, c, x.element_size())
    _, partials, _, mean, rstd = buffers
    stream = _build.stream_of(x)
    fn = _build.kernel_function("unet_instance_norm_partials", _PARTIALS_ARGTYPES)
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), partials.data_ptr(), _build.DTYPE_CODES[x.dtype], b, h * w, c,
                  chunk_px, nchunk, stream)
    _build.check(code, "unet_instance_norm_partials")
    _space_sum(partials, space_group)
    fn = _build.kernel_function("unet_instance_norm_finalize", _FINALIZE_ARGTYPES)
    with torch.cuda.device(x.device):
        code = fn(partials.data_ptr(), mean.data_ptr(), rstd.data_ptr(), b, nchunk, c, group,
                  float(h * w * group * _space_size(space_group)), eps, stream)
    _build.check(code, "unet_instance_norm_finalize")
    launch_forward(x, scale_c, bias_c, buffers, eps, negative_slope, group, APPLY)


def _cuda_forward(x, scale_c, bias_c, eps, negative_slope, group, space_group=None):
    _check("fused_instance_norm", x, scale_c, bias_c, group)
    x, scale_c, bias_c = x.contiguous(), _f32(scale_c), _f32(bias_c)
    buffers = forward_buffers(x)
    if space_group is None:
        launch_forward(x, scale_c, bias_c, buffers, eps, negative_slope, group)
    else:
        launch_split_forward(x, scale_c, bias_c, buffers, eps, negative_slope, group,
                             space_group)
        fused_instance_norm.split_launches += 1
    fused_instance_norm.launches += 1
    y, _, _, mean, rstd = buffers
    return y, mean, rstd


def _cuda_backward(x, scale_c, bias_c, mean, rstd, dy, negative_slope, group,
                   space_group=None):
    _check("fused_instance_norm backward", x, scale_c, bias_c, group)
    b, h, w, c = x.shape
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"fused_instance_norm backward: dy must be {tuple(x.shape)} "
                         f"{x.dtype}, got {tuple(dy.shape)} {dy.dtype}")
    for name, t in (("mean", mean), ("rstd", rstd)):
        if t.shape != (b, c) or t.dtype != torch.float32:
            raise ValueError(f"fused_instance_norm backward: {name} must be ({b}, {c}) "
                             f"float32, got {tuple(t.shape)} {t.dtype}")
    # The train step's cotangents arrive contiguous; others (the broadcast
    # cotangent of a sum, a slice) are copied.
    x, dy, mean, rstd = x.contiguous(), dy.contiguous(), mean.contiguous(), rstd.contiguous()
    scale_c, bias_c = _f32(scale_c), _f32(bias_c)
    cg = c // group
    dx = torch.empty_like(x)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, dy, dx))
    vec = 16 // x.element_size() if c % (16 // x.element_size()) == 0 and aligned else 1
    plan = bwd_plan(b, h * w, c, group, x.element_size(),
                    *_build.device_limits(x.device.index), vec, space_group is not None)
    stream = _build.stream_of(x)
    if not plan.fused:
        return _two_pass_backward(x, scale_c, bias_c, mean, rstd, dy, dx, negative_slope, group,
                                  stream, space_group)
    rows, tag = _bwd_rows(x.device, stream, plan.pieces * 2 * plan.cs)
    # dscale, dbias, img_sums (b, 2, cg) and the pairs' counts (zeroed by the
    # entry point) in one allocation.
    sums = torch.empty(2 * (b + 1) * cg + b * plan.nslices, dtype=torch.float32, device=x.device)
    dscale, dbias = sums[:cg], sums[cg:2 * cg]
    base = sums.data_ptr()
    fn = _build.kernel_function("unet_instance_norm_bwd", _BWD_ARGTYPES)
    with _build.on_device(x.device):
        code = fn(x.data_ptr(), dy.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                  scale_c.data_ptr(), bias_c.data_ptr(), rows.data_ptr(), base + 8 * cg,
                  base + 4 * 2 * (b + 1) * cg, dx.data_ptr(), base, base + 4 * cg,
                  _build.DTYPE_CODES[x.dtype], b, h * w, c, group, plan.vec, plan.cs,
                  plan.parts, plan.part_px, plan.rows, plan.ring_steps, plan.grid, tag,
                  negative_slope, stream)
    _build.check(code, "unet_instance_norm_bwd")
    fused_instance_norm.backward_launches += 1
    return dx, dscale, dbias


def _two_pass_backward(x, scale_c, bias_c, mean, rstd, dy, dx, negative_slope, group, stream,
                       space_group=None):
    """The two-pass kernel (a statistics pass, then an apply pass, each reading
    x and dy), on the forward's chunking. With a ``space_group`` it is two
    calls: the reduce, which also writes dscale and dbias from this rank's own
    sums, then the images' sums all-reduced over the group, then the apply
    with the whole image's pixel count."""
    b, h, w, c = x.shape
    cg = c // group
    chunk_px, nchunk = chunking(h * w, c, x.element_size())
    sums = torch.empty(2 * b * nchunk * c + 2 * (b + 1) * cg + b, dtype=torch.float32,
                       device=x.device)
    partials, img_sums, dscale, dbias, count = sums.split(
        [2 * b * nchunk * c, 2 * b * cg, cg, cg, b])
    fn = _build.kernel_function("unet_instance_norm_bwd_two_pass", _TWO_PASS_ARGTYPES)
    n = float(h * w * group * _space_size(space_group))

    def call(passes):
        with torch.cuda.device(x.device):
            code = fn(x.data_ptr(), dy.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                      scale_c.data_ptr(), bias_c.data_ptr(), partials.data_ptr(),
                      img_sums.data_ptr(), count.data_ptr(), dx.data_ptr(), dscale.data_ptr(),
                      dbias.data_ptr(), _build.DTYPE_CODES[x.dtype], b, h * w, c, group,
                      chunk_px, nchunk, n, negative_slope, passes, stream)
        _build.check(code, "unet_instance_norm_bwd_two_pass")

    if space_group is None:
        call(BOTH)
    else:
        call(STATS)
        _space_sum(img_sums, space_group)
        call(APPLY)
        fused_instance_norm.split_backward_launches += 1
    fused_instance_norm.backward_launches += 1
    return dx, dscale, dbias


# The backward kernel's rows of partials, per (device, stream): 64-bit words
# that carry the tag of the call that wrote them, and the last tag used. The
# buffer is the kernel's own and starts zeroed, so a word holds a call's tag
# only once that call has written it; tags run 1, 2, ... and wrap past 0.
_BWD_ROWS: dict = {}


def _bwd_rows(device: torch.device, stream: int, words: int) -> tuple[torch.Tensor, int]:
    """The tagged-row buffer of (device, stream), at least ``words`` long,
    and the tag of a new call."""
    rows, tag = _BWD_ROWS.get((device.index, stream), (None, 0))
    if rows is None or rows.numel() < words:
        rows, tag = torch.zeros(words, dtype=torch.int64, device=device), 0
    tag = tag % 0xFFFFFFFF + 1
    _BWD_ROWS[(device.index, stream)] = (rows, tag)
    return rows, tag


def _image_means(a: torch.Tensor, b: torch.Tensor, dims: tuple, space_group):
    """The means of ``a`` and ``b`` over ``dims`` (kept), over the whole
    images when ``space_group``'s ranks hold equal row shards of them."""
    if space_group is None:
        return a.mean(dim=dims, keepdim=True), b.mean(dim=dims, keepdim=True)
    sums = _space_sum(torch.stack([a.sum(dim=dims, keepdim=True),
                                   b.sum(dim=dims, keepdim=True)]), space_group)
    n = math.prod(a.shape[d] for d in dims) * _space_size(space_group)
    return sums[0] / n, sums[1] / n


def _torch_backward(x, scale_c, bias_c, mean, rstd, dy, negative_slope, group,
                    space_group=None):
    """The JAX ``_bwd_impl``: (dx in x's dtype, dscale, dbias) float32. With a
    ``space_group`` the input gradient's means are the whole images' (summed
    over the group's ranks); dscale and dbias stay this rank's rows' sums."""
    b, h, w, c = x.shape
    xf = x.to(torch.float32)
    dyf = dy.to(torch.float32)
    scale_full = scale_c.to(torch.float32).repeat(group)
    bias_full = bias_c.to(torch.float32).repeat(group)
    rstd_b = rstd[:, None, None, :]
    xhat = (xf - mean[:, None, None, :]) * rstd_b
    y_pre = xhat * scale_full + bias_full
    dpre = dyf * torch.where(y_pre >= 0, 1.0, negative_slope)
    # Parameter grads, pooled over the batch (and the group's q blocks).
    dscale = (dpre * xhat).sum(dim=(0, 1, 2))
    dbias = dpre.sum(dim=(0, 1, 2))
    if group > 1:
        dscale = dscale.reshape(group, c // group).sum(0)
        dbias = dbias.reshape(group, c // group).sum(0)
    # Input grad: the instance-norm backward with group-pooled means.
    dxhat = dpre * scale_full
    if group > 1:
        shape_g = (b, h, w, group, c // group)  # q-major sub-pixel axis
        dxhat_g, xhat_g = dxhat.reshape(shape_g), xhat.reshape(shape_g)
        m1, m2 = _image_means(dxhat_g, dxhat_g * xhat_g, (1, 2, 3), space_group)
        dx = (dxhat_g - m1 - xhat_g * m2).reshape(b, h, w, c)
    else:
        m1, m2 = _image_means(dxhat, dxhat * xhat, (1, 2), space_group)
        dx = dxhat - m1 - xhat * m2
    return (dx * rstd_b).to(x.dtype), dscale, dbias


class _FusedInstanceNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps, negative_slope, group, space_group):
        run = _cuda_forward if _build.uses_kernel(x, scale, bias) else _torch_forward
        y, mean, rstd = run(x, scale, bias, eps, negative_slope, group, space_group)
        ctx.save_for_backward(x, scale, bias, mean, rstd)
        ctx.negative_slope, ctx.group, ctx.space_group = negative_slope, group, space_group
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, bias, mean, rstd = ctx.saved_tensors
        run = _cuda_backward if _build.uses_kernel(x, dy) else _torch_backward
        dx, dscale, dbias = run(x, scale, bias, mean, rstd, dy, ctx.negative_slope, ctx.group,
                                ctx.space_group)
        return dx, dscale.to(scale.dtype), dbias.to(bias.dtype), None, None, None, None


def fused_instance_norm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    eps: float = 1e-5,
    negative_slope: float = 0.01,
    group: int = 1,
    space_group=None,
) -> torch.Tensor:
    """``leaky_relu(instance_norm(x) * scale + bias)`` of an NHWC tensor.

    ``x`` is (B, H, W, C), dense or space-to-depth q-major with ``group=4``;
    ``scale``/``bias`` have one float32 entry per original channel (C // group).
    ``space_group``: a process group whose ranks each hold an equal row shard
    of the same images, whose statistics are then the whole images'.
    """
    if x.ndim != 4:
        raise ValueError(f"fused_instance_norm takes (B, H, W, C), got {tuple(x.shape)}")
    return _FusedInstanceNorm.apply(x, scale, bias, eps, negative_slope, group, space_group)


# Kernel launches since the counts were last set to 0, of the forward and of
# the backward (CPU calls do not count); of those, the ones split around an
# all-reduce over a space group.
fused_instance_norm.launches = 0
fused_instance_norm.backward_launches = 0
fused_instance_norm.split_launches = 0
fused_instance_norm.split_backward_launches = 0
