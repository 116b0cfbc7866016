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
read x and dy once and write dx once. Each kernel reads its inputs twice
(statistics, then output), so it can reach at best 2/3 (forward) or 3/5
(backward) of that bound; see the source for the design.

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

import torch

from unet_implementations_tpu_torch.kernels import _build

# A block covers one chunk of an image's pixels: an image is cut into at most
# _MAX_CHUNKS chunks of at least _MIN_CHUNK_BYTES of x. The chunks depend on
# the image's shape alone, so an image's result does not depend on its batch.
_MAX_CHUNKS = 32
_MIN_CHUNK_BYTES = 64 * 1024
# ``passes`` of the forward entry point.
STATS, APPLY, BOTH = 1, 2, 3

_FWD_ARGTYPES = [ctypes.c_void_p] * 8 + [
    ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
]
_BWD_ARGTYPES = [ctypes.c_void_p] * 12 + [
    ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
]


def chunking(hw: int, c: int, itemsize: int) -> tuple[int, int]:
    """(pixels per block, blocks per image) of both kernels' passes."""
    chunk_px = max(-(-hw // _MAX_CHUNKS), _MIN_CHUNK_BYTES // (c * itemsize), 1)
    chunk_px = min(chunk_px, hw)
    return chunk_px, -(-hw // chunk_px)


def _torch_forward(x, scale_c, bias_c, eps, negative_slope, group):
    """Plain version: the op sequence of the JAX ``_jnp_forward``.

    x: (B, H, W, C); scale_c, bias_c: (C // group,) float32.
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


def _cuda_forward(x, scale_c, bias_c, eps, negative_slope, group):
    _check("fused_instance_norm", x, scale_c, bias_c, group)
    x, scale_c, bias_c = x.contiguous(), _f32(scale_c), _f32(bias_c)
    buffers = forward_buffers(x)
    launch_forward(x, scale_c, bias_c, buffers, eps, negative_slope, group)
    fused_instance_norm.launches += 1
    y, _, _, mean, rstd = buffers
    return y, mean, rstd


def _cuda_backward(x, scale_c, bias_c, mean, rstd, dy, negative_slope, group):
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
    chunk_px, nchunk = chunking(h * w, c, x.element_size())
    f32 = dict(dtype=torch.float32, device=x.device)
    partials = torch.empty((b, nchunk, 2, c), **f32)
    img_sums = torch.empty((b, 2, cg), **f32)
    count = torch.empty(b, dtype=torch.int32, device=x.device)
    dx = torch.empty_like(x)
    dscale, dbias = torch.empty(cg, **f32), torch.empty(cg, **f32)
    fn = _build.kernel_function("unet_instance_norm_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), dy.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                  scale_c.data_ptr(), bias_c.data_ptr(), partials.data_ptr(),
                  img_sums.data_ptr(), count.data_ptr(), dx.data_ptr(), dscale.data_ptr(),
                  dbias.data_ptr(),
                  _build.DTYPE_CODES[x.dtype], b, h * w, c, group, chunk_px, nchunk,
                  negative_slope, _build.stream_of(x))
    _build.check(code, "unet_instance_norm_bwd")
    fused_instance_norm.backward_launches += 1
    return dx, dscale, dbias


def _torch_backward(x, scale_c, bias_c, mean, rstd, dy, negative_slope, group):
    """The JAX ``_bwd_impl``: (dx in x's dtype, dscale, dbias) float32."""
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
        m1 = dxhat_g.mean(dim=(1, 2, 3), keepdim=True)
        m2 = (dxhat_g * xhat_g).mean(dim=(1, 2, 3), keepdim=True)
        dx = (dxhat_g - m1 - xhat_g * m2).reshape(b, h, w, c)
    else:
        m1 = dxhat.mean(dim=(1, 2), keepdim=True)
        m2 = (dxhat * xhat).mean(dim=(1, 2), keepdim=True)
        dx = dxhat - m1 - xhat * m2
    return (dx * rstd_b).to(x.dtype), dscale, dbias


class _FusedInstanceNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps, negative_slope, group):
        run = _cuda_forward if _build.uses_kernel(x, scale, bias) else _torch_forward
        y, mean, rstd = run(x, scale, bias, eps, negative_slope, group)
        ctx.save_for_backward(x, scale, bias, mean, rstd)
        ctx.negative_slope, ctx.group = negative_slope, group
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, bias, mean, rstd = ctx.saved_tensors
        run = _cuda_backward if _build.uses_kernel(x, dy) else _torch_backward
        dx, dscale, dbias = run(x, scale, bias, mean, rstd, dy, ctx.negative_slope, ctx.group)
        return dx, dscale.to(scale.dtype), dbias.to(bias.dtype), None, None, None


def fused_instance_norm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    eps: float = 1e-5,
    negative_slope: float = 0.01,
    group: int = 1,
) -> torch.Tensor:
    """``leaky_relu(instance_norm(x) * scale + bias)`` of an NHWC tensor.

    ``x`` is (B, H, W, C), dense or space-to-depth q-major with ``group=4``;
    ``scale``/``bias`` have one float32 entry per original channel (C // group).
    """
    if x.ndim != 4:
        raise ValueError(f"fused_instance_norm takes (B, H, W, C), got {tuple(x.shape)}")
    return _FusedInstanceNorm.apply(x, scale, bias, eps, negative_slope, group)


# Kernel launches since the counts were last set to 0, of the forward and of
# the backward (CPU calls do not count).
fused_instance_norm.launches = 0
fused_instance_norm.backward_launches = 0
