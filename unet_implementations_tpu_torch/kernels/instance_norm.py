"""K1: fused InstanceNorm + LeakyReLU forward (CUDA, ``csrc/instance_norm.cu``).

Replaces ``unet_implementations_tpu/kernels/instance_norm.py::_pallas_forward``
(``_stats_kernel`` and ``_normalize_kernel``). It follows every block conv of
the UNet: 22 calls per forward of the 6-stage model.

``y = lrelu((x - mean) * rstd * scale + bias)`` per (image, channel) over
H*W, with float32 sums, biased variance, and ``y`` computed in float32 and
rounded once to x's dtype. With ``group=4`` the statistics pool the four
q-major sub-pixel blocks of a space-to-depth tensor (channel = q*Cg + c).

Bound: bytes — one read of x and one write of y. The kernel reads x twice
(statistics, then normalize), so it can reach at best 2/3 of that bound; see
the source for the design.

On a CPU tensor ``fused_instance_norm`` runs the plain version
``_torch_forward``; on a CUDA tensor it launches the kernel or raises.

It is differentiable. The backward is ``_torch_backward``, the formula of the
JAX ``_bwd_impl`` in plain torch ops on both devices: the JAX package has no
backward kernel for K1 (its ``_bwd_impl`` is jnp, compiled by XLA), so there
is none here either. It works in float32 from the saved x, mean and rstd,
pools ``dscale``/``dbias`` over the batch (and the 4 q blocks with
``group=4``), and returns dx in x's dtype.
"""

from __future__ import annotations

import ctypes

import torch

from unet_implementations_tpu_torch.kernels import _build

# Bytes of x a block of the statistics pass reduces.
_STATS_CHUNK_BYTES = 64 * 1024

_ARGTYPES = [ctypes.c_void_p] * 7 + [
    ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
]


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


def _cuda_forward(x, scale_c, bias_c, eps, negative_slope, group):
    b, h, w, c = x.shape
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"fused_instance_norm takes float32 or bfloat16, got {x.dtype}")
    if c % group or scale_c.shape != (c // group,) or bias_c.shape != (c // group,):
        raise ValueError(
            f"scale/bias must have C/group = {c}/{group} entries, got "
            f"{tuple(scale_c.shape)} and {tuple(bias_c.shape)}")
    x = x.contiguous()
    scale_c = scale_c.to(torch.float32).contiguous()
    bias_c = bias_c.to(torch.float32).contiguous()
    hw = h * w
    chunk_px = max(1, _STATS_CHUNK_BYTES // (c * x.element_size()))
    nchunk = -(-hw // chunk_px)
    y = torch.empty_like(x)
    partials = torch.empty((b, nchunk, 2, c), dtype=torch.float32, device=x.device)
    mean = torch.empty((b, c), dtype=torch.float32, device=x.device)
    rstd = torch.empty((b, c), dtype=torch.float32, device=x.device)
    fn = _build.kernel_function("unet_instance_norm_fwd", _ARGTYPES)
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), y.data_ptr(), scale_c.data_ptr(), bias_c.data_ptr(),
                  partials.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                  _build.DTYPE_CODES[x.dtype], b, hw, c, group, chunk_px, nchunk,
                  eps, negative_slope, _build.stream_of(x))
    _build.check(code, "unet_instance_norm_fwd")
    fused_instance_norm.launches += 1
    return y, mean, rstd


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
        dx, dscale, dbias = _torch_backward(x, scale, bias, mean, rstd, dy, ctx.negative_slope,
                                            ctx.group)
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


# Kernel launches since the count was last set to 0 (CPU calls do not count).
fused_instance_norm.launches = 0
