"""Frozen copy of the port's class-balanced augmentation, as the plain
reference of the online-augmented training cells.

Copied from ``unet_implementations_tpu_torch/data/augment.py`` (its policy
table, ``sample_params``, ``apply_params`` and helpers, and
``augment_and_normalize_with_clip``), with the few helpers it imported from
the port (``normalize_image``, ``resize_bilinear``, the ImageNet statistics)
copied below, so that later changes to the program cannot move it. Plain
torch: every branch computed for the whole batch and selected per image.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize_image(image: torch.Tensor, mode: str = "imagenet") -> torch.Tensor:
    """uint8 pixels -> float32: /255, then (imagenet) the ImageNet statistics;
    float input passes through."""
    if image.dtype != torch.uint8:
        return image
    img = image.to(torch.float32) / 255.0
    if mode == "unit":
        return img
    mean = torch.from_numpy(IMAGENET_MEAN).to(image.device)
    std = torch.from_numpy(IMAGENET_STD).to(image.device)
    return (img - mean) / std


def _linear_weights(out_size: int, in_size: int, device=None):
    scale = float(np.float32(in_size / out_size))
    src = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * scale - 0.5
    src = torch.clamp_min(src, 0.0)
    i0 = torch.clamp(torch.floor(src).to(torch.int64), 0, in_size - 1)
    i1 = torch.clamp(i0 + 1, 0, in_size - 1)
    w1 = src - i0.to(torch.float32)
    return i0, i1, w1


def _interp_axis(x: torch.Tensor, axis: int, out_size: int) -> torch.Tensor:
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    i0, i1, w1 = _linear_weights(out_size, in_size, x.device)
    x0 = torch.index_select(x, axis, i0)
    x1 = torch.index_select(x, axis, i1)
    shape = [1] * x.ndim
    shape[axis] = out_size
    w1 = w1.reshape(shape).to(x0.dtype)
    return x0 * (1 - w1) + x1 * w1


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize (half-pixel centres, edges clamped) of NHWC x, in float32."""
    orig_dtype = x.dtype
    x = x.to(torch.float32)
    x = _interp_axis(x, 1, size[0])
    x = _interp_axis(x, 2, size[1])
    return x.to(orig_dtype)

# ---------------------------------------------------------------------------
# Policy tables (from the reference's data_augmentation/config/
# augmentation_config.yaml). Index 0 = cat (aggressive), 1 = dog.
# ---------------------------------------------------------------------------

POLICY: Dict[str, Tuple[float, float]] = {
    "hflip_prob": (0.5, 0.5),
    "ssr_prob": (0.8, 0.5),
    "shift_limit": (0.1, 0.05),
    "scale_limit": (0.15, 0.1),
    "rotate_limit": (15.0, 10.0),
    "rrc_prob": (0.3, 0.2),
    "rrc_scale_min": (0.8, 0.9),
    "dropout_prob": (0.4, 0.3),
    "dropout_max": (45.0, 45.0),
    "distort_prob": (0.3, 0.2),           # OneOf[elastic/grid/optical]
    "elastic_alpha": (40.0, 30.0),
    "elastic_sigma": (4.0, 3.0),
    "grid_distort_limit": (0.2, 0.15),
    "optical_distort_limit": (0.2, 0.15),
    "perspective_prob": (0.3, 0.2),
    "perspective_scale": (0.1, 0.07),
    "color_prob": (0.8, 0.6),             # OneOf[bc/hsv/rgb]
    "brightness_limit": (0.176, 0.176),
    "contrast_lo": (-0.9, -0.9),
    "contrast_hi": (0.25, 0.25),
    "hue_shift": (10.0, 5.0),
    "sat_shift": (30.0, 20.0),
    "val_shift": (20.0, 15.0),
    "rgb_shift": (15.0, 10.0),
    "hist_prob": (0.3, 0.2),              # OneOf[clahe/equalize/gray]
    "noise_prob": (0.4, 0.3),             # OneOf[gauss/gblur/mblur]
    "gauss_var_max": (18.0, 18.0),
    "blur_sigma_max": (2.0, 2.0),
    "saltpepper_prob": (0.3, 0.2),
    "sp_amount_max": (0.18, 0.18),
    "iso_prob": (0.3, 0.2),
    "iso_intensity_max": (0.5, 0.3),
    "lighting_prob": (0.3, 0.2),          # OneOf[shadow/flare/fog]
    "fog_coef_max": (0.3, 0.2),
}

Policy = Dict[str, torch.Tensor]


def policy_arrays(policy=None, device=None) -> Policy:
    """A POLICY-style table as (2,) float32 tensors on ``device``. Build it
    once per device and pass it to every batch: building it copies from the
    host, which on a card waits for the queue."""
    src = POLICY if policy is None else policy
    return {k: torch.tensor(v, dtype=torch.float32, device=device) for k, v in src.items()}


def _tables(policy, device: torch.device) -> Policy:
    """``policy`` as tensors on ``device``: a table already there as it is,
    else (the built-in one for None) converted."""
    if policy is not None and all(isinstance(v, torch.Tensor) and v.device == device
                                  for v in policy.values()):
        return policy
    return policy_arrays(policy, device)


@functools.lru_cache(maxsize=None)
def _imagenet_stats(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ImageNet mean and std on ``device``, copied there once (a copy
    from the host would wait for the card's queue on every batch)."""
    return (torch.from_numpy(IMAGENET_MEAN).to(device),
            torch.from_numpy(IMAGENET_STD).to(device))


def _matrix(rows, like: torch.Tensor) -> torch.Tensor:
    """(B, 3, 3) from nine entries, each a (B,) tensor or a number (filled
    to the shape of ``like``)."""
    return torch.stack([torch.stack([v if isinstance(v, torch.Tensor)
                                     else torch.full_like(like, v) for v in row], -1)
                        for row in rows], -2)


def _translate(tx: torch.Tensor, ty: torch.Tensor) -> torch.Tensor:
    return _matrix([[1.0, 0.0, tx], [0.0, 1.0, ty], [0.0, 0.0, 1.0]], tx)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, 3, 3) @ (B, 3, 3) as elementwise products summed in a fixed
    order, so the CPU and the card compose the same bits (a BLAS product
    may order and fuse its sums otherwise)."""
    p = a[:, :, :, None] * b[:, None, :, :]
    return p[:, :, 0] + p[:, :, 1] + p[:, :, 2]


def _scale_rotate(scale: torch.Tensor, angle_deg: torch.Tensor, cx: float,
                  cy: float) -> torch.Tensor:
    """Rotation and scale about the centre (cx, cy), output → source. The
    cosine and sine are taken in float64 and rounded once, so the CPU's and
    the card's libraries give the same float32."""
    a = _div(-angle_deg * np.pi, 180.0)  # the inverse rotation
    inv_s = 1.0 / scale
    cos = torch.cos(a.double()).float() * inv_s
    sin = torch.sin(a.double()).float() * inv_s
    m = _matrix([[cos, -sin, 0.0], [sin, cos, 0.0], [0.0, 0.0, 1.0]], scale)
    return _mm(_mm(_translate(torch.full_like(scale, cx), torch.full_like(scale, cy)), m),
               _translate(torch.full_like(scale, -cx), torch.full_like(scale, -cy)))


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` divided on every device: CUDA multiplies by the reciprocal
    of a host scalar divisor, which may differ from the quotient in the last
    bit, so the divisor is a tensor on ``x``'s device."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def _select(gate: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a`` where the per-image ``gate`` (B,) holds, else ``b``."""
    return torch.where(gate.reshape(-1, *[1] * (a.ndim - 1)), a, b)


def _pick(index: torch.Tensor, branches) -> torch.Tensor:
    """Per image, the branch ``index`` (B,) names (``lax.switch``)."""
    out = branches[-1]
    for i in range(len(branches) - 2, -1, -1):
        out = _select(index == i, branches[i], out)
    return out


def _homography(params: Dict, h: int, w: int) -> torch.Tensor:
    """Flip, shift-scale-rotate and resized crop in the reference's forward
    order, then the perspective: the forward chain rrc(ssr(flip(x))) maps
    output to source as ``H = M_flip @ M_ssr @ M_rrc``, then ``H @ P``."""
    flip_gate = params["flip"]
    b = flip_gate.shape[0]
    dev = flip_gate.device
    eye = torch.eye(3, device=dev).expand(b, 3, 3)
    flip = eye.clone()  # x_src = (w - 1) - x_out
    flip[:, 0, 0] = -1.0
    flip[:, 0, 2] = w - 1.0
    H = _select(flip_gate, _mm(eye, flip), eye)

    shift = params["shift"]
    ssr = _mm(_scale_rotate(params["scale"], params["angle"], (w - 1) / 2, (h - 1) / 2),
              _translate(-shift[:, 0] * w, -shift[:, 1] * h))
    H = _select(params["ssr"], _mm(H, ssr), H)

    side = torch.sqrt(params["area"])
    off = params["off"]
    rrc = _matrix([[side, 0.0, off[:, 0] * w], [0.0, side, off[:, 1] * h], [0.0, 0.0, 1.0]],
                  side)
    H = _select(params["rrc"], _mm(H, rrc), H)
    return _mm(H, _select(params["perspective"], _perspective(params["jitter"], h, w), eye))


def _perspective(jitter: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The corner-jitter perspective of (B, 8) jitters (albumentations-style):
    the projective row and mild affine terms."""
    j = jitter.unbind(-1)
    eps_x = _div(j[0], w)
    eps_y = _div(j[1], h)
    return _matrix([
        [1.0 + j[2] * 0.1, j[3] * 0.1, j[4] * 0.05 * w],
        [j[5] * 0.1, 1.0 + j[6] * 0.1, j[7] * 0.05 * h],
        [eps_x * 0.5, eps_y * 0.5, 1.0],
    ], eps_x)


def _upsample_grid(coarse: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, C, g, g) → (B, C, h, w), bilinear with half-pixel centres."""
    return resize_bilinear(coarse.permute(0, 2, 3, 1), (h, w)).permute(0, 3, 1, 2)


def _displacement_field(do: torch.Tensor, pick: torch.Tensor, elastic: torch.Tensor,
                        grid: torch.Tensor, optical: torch.Tensor, h: int,
                        w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """OneOf[elastic / grid distortion / optical distortion] as (dy, dx),
    each (B, h, w): ``elastic`` the (B, 2, 16, 16) coarse noise field already
    scaled by alpha / 8, ``grid`` the (B, 2, 5, 5) per-cell offsets in
    pixels, ``optical`` the (B,) radial coefficient; zero where ``do`` is
    off."""
    dev = elastic.device
    yy = _div(torch.arange(h, dtype=torch.float32, device=dev) - (h - 1) / 2, h)
    xx = _div(torch.arange(w, dtype=torch.float32, device=dev) - (w - 1) / 2, w)
    ys, xs = torch.meshgrid(yy, xx, indexing="ij")
    r2 = ys * ys + xs * xs
    kk = optical[:, None, None]
    optical_field = torch.stack([ys * r2 * kk * h, xs * r2 * kk * w], 1)
    field = _pick(pick, [_upsample_grid(elastic, h, w), _upsample_grid(grid, h, w),
                         optical_field])
    field = _select(do, field, torch.zeros_like(field))
    return field[:, 0], field[:, 1]


def _reflect101(coord: torch.Tensor, size: int) -> torch.Tensor:
    """OpenCV BORDER_REFLECT_101 coordinate folding (floor-mod, as jnp)."""
    period = 2.0 * (size - 1)
    c = torch.remainder(torch.abs(coord), period)
    return torch.where(c > size - 1, period - c, c)


def warp_pair(images: torch.Tensor, masks: torch.Tensor, H: torch.Tensor,
              dy: torch.Tensor, dx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One gather pass: images (B, h, w, C) bilinear with REFLECT_101
    borders, masks (B, h, w) nearest with fill 0, at the source coordinates
    ``H`` (B, 3, 3) gives for each output pixel, plus (dy, dx) (B, h, w)."""
    b, h, w, c = images.shape
    dev = images.device
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    Hc = H[:, :, :, None, None]
    src = Hc[:, :, 0] * gx + Hc[:, :, 1] * gy + Hc[:, :, 2]  # (B, 3, h, w)
    sx = src[:, 0] / src[:, 2] + dx
    sy = src[:, 1] / src[:, 2] + dy

    # Image: bilinear, REFLECT_101.
    rx = _reflect101(sx, w)
    ry = _reflect101(sy, h)
    x0 = torch.clamp(torch.floor(rx), 0, w - 1)
    y0 = torch.clamp(torch.floor(ry), 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    wx = (rx - x0)[..., None]
    wy = (ry - y0)[..., None]
    x0i, x1i, y0i, y1i = (a.to(torch.int64) for a in (x0, x1, y0, y1))
    flat = images.reshape(b, h * w, c)

    def g(yi, xi):
        idx = (yi * w + xi).reshape(b, h * w, 1).expand(b, h * w, c)
        return torch.gather(flat, 1, idx).reshape(b, h, w, c)

    img = (g(y0i, x0i) * (1 - wy) * (1 - wx)
           + g(y0i, x1i) * (1 - wy) * wx
           + g(y1i, x0i) * wy * (1 - wx)
           + g(y1i, x1i) * wy * wx)

    # Mask: nearest (round half to even, as jnp.round), out of bounds → 0.
    nx = torch.round(sx).to(torch.int32)
    ny = torch.round(sy).to(torch.int32)
    inside = (nx >= 0) & (nx < w) & (ny >= 0) & (ny < h)
    nidx = (torch.clamp(ny, 0, h - 1).to(torch.int64) * w
            + torch.clamp(nx, 0, w - 1).to(torch.int64)).reshape(b, h * w)
    m = torch.gather(masks.reshape(b, h * w), 1, nidx).reshape(b, h, w)
    return img, torch.where(inside, m, torch.zeros_like(m))


# ---------------------------------------------------------------------------
# Pixel transforms (image only), over (..., 3) images.
# ---------------------------------------------------------------------------


def _rgb_to_hsv(img: torch.Tensor) -> torch.Tensor:
    return torch.stack(_rgb_to_hsv_tuple(img), dim=-1)


def _rgb_to_hsv_tuple(img: torch.Tensor):
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    d = mx - mn + 1e-12
    h = _div(torch.where(mx == r, torch.remainder((g - b) / d, 6.0),
                         torch.where(mx == g, (b - r) / d + 2.0, (r - g) / d + 4.0)), 6.0)
    s = d / (mx + 1e-12)
    return torch.remainder(h, 1.0), s, mx


def _hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    pp = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    i = torch.remainder(i.to(torch.int32), 6)

    def select(values):
        out = values[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, values[k], out)
        return out

    r = select([v, q, pp, pp, t, v])
    g = select([t, v, v, q, pp, pp])
    b = select([pp, pp, t, v, v, q])
    return torch.stack([r, g, b], dim=-1)


def _histograms(u8: torch.Tensor) -> torch.Tensor:
    """(B, h, w, C) integer values in [0, 255] → (B, C, 256) float32 counts,
    one ``index_add_`` over the bins ``(b·C + c)·256 + value``."""
    b, c = u8.shape[0], u8.shape[-1]
    idx = _bin_index(u8)
    counts = torch.zeros(b * c * 256, dtype=torch.float32, device=u8.device)
    counts.index_add_(0, idx.reshape(-1),
                      torch.ones(idx.numel(), dtype=torch.float32, device=u8.device))
    return counts.reshape(b, c, 256)


def _bin_index(u8: torch.Tensor) -> torch.Tensor:
    b, c = u8.shape[0], u8.shape[-1]
    offset = (torch.arange(b * c, device=u8.device) * 256).reshape(b, *[1] * (u8.ndim - 2), c)
    return u8.to(torch.int64) + offset


def _lut_from_hist(hist: torch.Tensor, clip_limit: float = 0.0) -> torch.Tensor:
    """Equalization LUTs (..., 256) in [0, 1] from 256-bin histograms.

    ``clip_limit`` > 0 applies CLAHE-style contrast limiting (a global
    approximation of the reference's 8x8-tile CLAHE)."""
    if clip_limit > 0:
        cap = clip_limit * torch.mean(hist, dim=-1, keepdim=True)
        excess = torch.sum(torch.clamp_min(hist - cap, 0.0), dim=-1, keepdim=True)
        hist = torch.minimum(hist, cap) + excess / 256.0
    cdf = torch.cumsum(hist, dim=-1)
    return (cdf - cdf[..., :1]) / torch.clamp_min(cdf[..., -1:] - cdf[..., :1], 1.0)


def _equalize_lut(channel_u8: torch.Tensor, clip_limit: float = 0.0) -> torch.Tensor:
    """The equalization LUT (256,) of one uint8-valued channel."""
    return _lut_from_hist(_histograms(channel_u8.reshape(1, -1, 1))[0, 0], clip_limit)


def _taps(x: torch.Tensor, weights: torch.Tensor, axis: int) -> torch.Tensor:
    """Zero-padded cross-correlation of (B, h, w, C) images along ``axis``
    (1 or 2) with per-image taps ``weights`` (B, k), k odd, as elementwise
    multiply-adds in float32 (no convolution engine, so no TF32)."""
    k = weights.shape[1]
    half = k // 2
    pad = [0, 0, 0, 0, 0, 0]
    pad[2 * (3 - axis)] = pad[2 * (3 - axis) + 1] = half
    xp = F.pad(x, pad)
    n = x.shape[axis]
    out = None
    for i in range(k):
        term = xp.narrow(axis, i, n) * weights[:, i, None, None, None]
        out = term if out is None else out + term
    return out


def _gaussian_blur(img: torch.Tensor, sigma: torch.Tensor, ksize: int = 9) -> torch.Tensor:
    """Separable depthwise Gaussian blur of (B, h, w, C) with per-image sigma
    (B,), 9 taps, zero padding."""
    half = ksize // 2
    xs = torch.arange(ksize, dtype=torch.float32, device=img.device) - half
    sig = torch.clamp_min(sigma, 1e-3)[:, None]
    k = torch.exp(-(xs ** 2) / (2 * sig ** 2))
    k = k / torch.sum(k, dim=-1, keepdim=True)
    return _taps(_taps(img, k, 1), k, 2)


def _motion_kernels(device) -> torch.Tensor:
    """The four 3x3 directional kernels: horizontal, vertical, diagonal and
    anti-diagonal (``fliplr(eye(3))``), 1/3 on each tap."""
    k = torch.zeros(4, 3, 3, device=device)
    k[0, 1, :] = 1 / 3
    k[1, :, 1] = 1 / 3
    k[2] = torch.eye(3, device=device) / 3
    k[3] = torch.fliplr(torch.eye(3, device=device)) / 3
    return k


def _motion_blur(img: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """3-tap directional blur of (B, h, w, C) in per-image ``direction`` (B,)
    in 0..3: a zero-padded 3x3 cross-correlation."""
    k = _motion_kernels(img.device)[direction]  # (B, 3, 3)
    h, w = img.shape[1:3]
    xp = F.pad(img, (0, 0, 1, 1, 1, 1))
    out = None
    for i in range(3):
        for j in range(3):
            term = xp[:, i:i + h, j:j + w] * k[:, i, j, None, None, None]
            out = term if out is None else out + term
    return out


def _luma(img: torch.Tensor) -> torch.Tensor:
    return 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]


# ---------------------------------------------------------------------------
# The batch augmenter: sampling, then a deterministic application.
# ---------------------------------------------------------------------------

# The per-image scalars of one batch, drawn as the columns of one uniform
# (B, N) call: name -> number of columns.
_UNIFORM_COLUMNS = (
    ("flip", 1), ("ssr", 1), ("shift", 2), ("scale", 1), ("angle", 1), ("rrc", 1),
    ("area", 1), ("off", 2), ("perspective", 1), ("jitter", 8),
    ("distort", 1), ("distort_pick", 1), ("optical", 1),
    ("dropout", 1), ("hole_h", 1), ("hole_w", 1), ("hole_cy", 1), ("hole_cx", 1),
    ("color", 1), ("color_pick", 1), ("brightness", 1), ("contrast", 1), ("hsv_shift", 3),
    ("rgb_shift", 3),
    ("hist", 1), ("hist_pick", 1),
    ("noise", 1), ("noise_pick", 1), ("noise_var", 1), ("blur_sigma", 1), ("motion_dir", 1),
    ("saltpepper", 1), ("sp_amount", 1),
    ("iso", 1), ("iso_intensity", 1),
    ("lighting", 1), ("lighting_pick", 1), ("fog", 1),
)


def _columns(u: torch.Tensor) -> Dict[str, torch.Tensor]:
    out, start = {}, 0
    for name, n in _UNIFORM_COLUMNS:
        out[name] = u[:, start] if n == 1 else u[:, start:start + n]
        start += n
    return out


def _randint(u: torch.Tensor, n: int) -> torch.Tensor:
    return torch.clamp(torch.floor(u * n), max=n - 1).to(torch.int64)


def _sym(u: torch.Tensor) -> torch.Tensor:
    """A uniform draw in [0, 1) mapped to [-1, 1)."""
    return u * 2.0 - 1.0


def sample_params(generator: torch.Generator, class_idx: torch.Tensor, policy,
                  h: int, w: int) -> Dict[str, torch.Tensor]:
    """Every draw of one batch: per image (``class_idx`` (B,) int, 0 = cat,
    1 = dog) the gates, branch picks and scalars, and the noise arrays, from
    ``generator`` on the batch's device in seven calls. The values are those
    ``augment_one`` computes from its draws (limits applied):

    - geometry: ``flip``, ``ssr``, ``rrc``, ``perspective`` (bool);
      ``shift`` (B, 2) fractions of the size, ``scale``, ``angle`` (degrees),
      ``area`` (the crop's area fraction), ``off`` (B, 2) its offset
      fractions, ``jitter`` (B, 8);
    - distortion: ``distort``, ``distort_pick`` (0 elastic, 1 grid, 2
      optical), ``elastic`` (B, 2, 16, 16) normal × alpha / 8, ``grid`` (B, 2,
      5, 5) cell offsets in pixels, ``optical`` (B,) radial coefficient;
    - dropout: ``dropout``, ``hole_h``, ``hole_w`` (pixels), ``hole_cy``,
      ``hole_cx`` (pixels);
    - colour: ``color``, ``color_pick`` (0 brightness-contrast, 1 HSV, 2 RGB
      shift), ``brightness``, ``contrast`` (the factor), ``hsv_shift`` (B, 3)
      the additive (hue, saturation, value) offsets, ``rgb_shift`` (B, 3);
    - histogram: ``hist``, ``hist_pick`` (0 CLAHE, 1 equalize, 2 gray);
    - noise: ``noise``, ``noise_pick`` (0 Gaussian noise, 1 Gaussian blur, 2
      motion blur), ``noise_std``, ``gauss`` (B, h, w, 3) standard normal,
      ``blur_sigma``, ``motion_dir`` (0..3);
    - ``saltpepper``, ``sp_amount``, ``sp_u`` (B, h, w) uniform;
    - ``iso``, ``iso_intensity``, ``iso_noise`` (B, h, w, 3) standard normal;
    - ``lighting``, ``lighting_pick`` (0 shadow, 1 flare, 2 fog),
      ``light_field`` (B, 8, 8) uniform, ``fog``.
    """
    dev = class_idx.device
    p = {k: v[class_idx] for k, v in _tables(policy, dev).items()}
    b = class_idx.shape[0]
    n = sum(k for _, k in _UNIFORM_COLUMNS)
    u = _columns(torch.rand((b, n), generator=generator, device=dev))
    elastic = torch.randn((b, 2, 16, 16), generator=generator, device=dev)
    cells = torch.rand((b, 2, 5, 5), generator=generator, device=dev)
    light = torch.rand((b, 8, 8), generator=generator, device=dev)
    gauss = torch.randn((b, h, w, 3), generator=generator, device=dev)
    iso_noise = torch.randn((b, h, w, 3), generator=generator, device=dev)
    sp_u = torch.rand((b, h, w), generator=generator, device=dev)

    lo, hi = p["contrast_lo"], p["contrast_hi"]
    area = p["rrc_scale_min"] + u["area"] * (1.0 - p["rrc_scale_min"])
    # The grid's offsets are in cells: rows of h / 5 and columns of w / 5.
    cell_hw = torch.stack([torch.full_like(lo, h / 5), torch.full_like(lo, w / 5)], 1)
    return {
        "flip": u["flip"] < p["hflip_prob"],
        "ssr": u["ssr"] < p["ssr_prob"],
        "shift": _sym(u["shift"]) * p["shift_limit"][:, None],
        "scale": 1.0 + _sym(u["scale"]) * p["scale_limit"],
        "angle": _sym(u["angle"]) * p["rotate_limit"],
        "rrc": u["rrc"] < p["rrc_prob"],
        "area": area,
        "off": u["off"] * (1.0 - torch.sqrt(area))[:, None],
        "perspective": u["perspective"] < p["perspective_prob"],
        "jitter": _sym(u["jitter"]) * p["perspective_scale"][:, None],
        "distort": u["distort"] < p["distort_prob"],
        "distort_pick": _randint(u["distort_pick"], 3),
        "elastic": elastic * p["elastic_alpha"][:, None, None, None] / 8.0,
        "grid": _sym(cells) * p["grid_distort_limit"][:, None, None, None]
        * cell_hw[:, :, None, None] * 0.5,
        "optical": _sym(u["optical"]) * p["optical_distort_limit"],
        "dropout": u["dropout"] < p["dropout_prob"],
        "hole_h": u["hole_h"] * p["dropout_max"],
        "hole_w": u["hole_w"] * p["dropout_max"],
        "hole_cy": u["hole_cy"] * h,
        "hole_cx": u["hole_cx"] * w,
        "color": u["color"] < p["color_prob"],
        "color_pick": _randint(u["color_pick"], 3),
        "brightness": _sym(u["brightness"]) * p["brightness_limit"],
        "contrast": 1.0 + (lo + u["contrast"] * (hi - lo)),
        "hsv_shift": _sym(u["hsv_shift"]) * torch.stack(
            [p["hue_shift"] / 360.0, p["sat_shift"] / 255.0, p["val_shift"] / 255.0], 1),
        "rgb_shift": _sym(u["rgb_shift"]) * (p["rgb_shift"] / 255.0)[:, None],
        "hist": u["hist"] < p["hist_prob"],
        "hist_pick": _randint(u["hist_pick"], 3),
        "noise": u["noise"] < p["noise_prob"],
        "noise_pick": _randint(u["noise_pick"], 3),
        "noise_std": torch.sqrt(u["noise_var"] * p["gauss_var_max"]) / 255.0,
        "gauss": gauss,
        "blur_sigma": u["blur_sigma"] * p["blur_sigma_max"],
        "motion_dir": _randint(u["motion_dir"], 4),
        "saltpepper": u["saltpepper"] < p["saltpepper_prob"],
        "sp_amount": u["sp_amount"] * p["sp_amount_max"] * 0.5,
        "sp_u": sp_u,
        "iso": u["iso"] < p["iso_prob"],
        "iso_intensity": u["iso_intensity"] * p["iso_intensity_max"],
        "iso_noise": iso_noise,
        "lighting": u["lighting"] < p["lighting_prob"],
        "lighting_pick": _randint(u["lighting_pick"], 3),
        "light_field": light,
        "fog": u["fog"] * p["fog_coef_max"],
    }


def _per_image(v: torch.Tensor, ndim: int = 4) -> torch.Tensor:
    """A (B,) or (B, k) parameter shaped to broadcast over (B, h, w, k)."""
    return v.reshape(v.shape[0], *[1] * (ndim - v.ndim), *v.shape[1:])


@torch.no_grad()
def apply_params(params: Dict[str, torch.Tensor], images01: torch.Tensor,
                 masks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The augmentation ``params`` (``sample_params``) describe, applied to
    images (B, h, w, 3) float32 in [0, 1] and masks (B, h, w) integer.
    Deterministic; returns float32 images in [0, 1] and masks of the input's
    dtype."""
    image, mask = _warp_and_colour(params, images01.to(torch.float32), masks)
    return _histogram_noise_light(params, image), mask


def _warp_and_colour(P: Dict[str, torch.Tensor], image: torch.Tensor,
                     masks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stages up to the histogram's: the warp, the coarse dropout and
    the colour OneOf. Their arithmetic is elementwise float32 in a fixed
    order (no BLAS, no fused multiply-add, true division: ``_div``), so the
    CPU and the card give the same bits: the histogram stage truncates to
    uint8, and a last-bit difference there would move a pixel to the next
    bin."""
    b, h, w, _ = image.shape

    # ---- geometric: one homography + displacement, one sampling pass ----
    H = _homography(P, h, w)
    dy, dx = _displacement_field(P["distort"], P["distort_pick"], P["elastic"], P["grid"],
                                 P["optical"], h, w)
    image, mask = warp_pair(image, masks, H, dy, dx)

    # ---- coarse dropout (image only, fill 0) ----
    yy = torch.arange(h, dtype=torch.float32, device=image.device)[None, :, None]
    xx = torch.arange(w, dtype=torch.float32, device=image.device)[None, None, :]
    hole = ((torch.abs(yy - P["hole_cy"][:, None, None]) < (P["hole_h"] / 2)[:, None, None])
            & (torch.abs(xx - P["hole_cx"][:, None, None]) < (P["hole_w"] / 2)[:, None, None]))
    image = torch.where((P["dropout"][:, None, None] & hole)[..., None], 0.0, image)

    # ---- OneOf colour: brightness-contrast / HSV / RGB shift ----
    img_bc = torch.clamp(image * _per_image(P["contrast"]) + _per_image(P["brightness"]),
                         0.0, 1.0)
    hh, ss, vv = _rgb_to_hsv_tuple(image)
    shift = P["hsv_shift"]
    hh = torch.remainder(hh + _per_image(shift[:, 0], 3), 1.0)
    ss = ss + _per_image(shift[:, 1], 3)
    vv = vv + _per_image(shift[:, 2], 3)
    hsv = torch.clamp(torch.stack([hh, ss, vv], dim=-1), 0.0, 1.0)
    img_hsv = torch.clamp(_hsv_to_rgb(hsv), 0.0, 1.0)
    img_rgb = torch.clamp(image + _per_image(P["rgb_shift"]), 0.0, 1.0)
    image = _select(P["color"], _pick(P["color_pick"], [img_bc, img_hsv, img_rgb]), image)
    return image, mask


def _histogram_noise_light(P: Dict[str, torch.Tensor], image: torch.Tensor) -> torch.Tensor:
    """The stages from the histogram's on: the histogram OneOf, the noise
    OneOf, salt and pepper, ISO noise and the lighting OneOf."""
    b, h, w, _ = image.shape

    # ---- OneOf histogram: CLAHE / equalize / to-gray (one histogram per
    # channel feeds both LUTs) ----
    u8 = torch.clamp(image * 255.0, 0, 255).to(torch.int32)
    hist = _histograms(u8)
    idx = _bin_index(u8)
    img_clahe = _lut_from_hist(hist, 4.0).reshape(-1)[idx]
    img_eq = _lut_from_hist(hist, 0.0).reshape(-1)[idx]
    img_gray = _luma(image)[..., None].expand(b, h, w, 3)
    image = _select(P["hist"], _pick(P["hist_pick"], [img_clahe, img_eq, img_gray]), image)

    # ---- OneOf noise: Gaussian noise / Gaussian blur / motion blur ----
    img_gn = torch.clamp(image + _per_image(P["noise_std"]) * P["gauss"], 0, 1)
    img_gb = _gaussian_blur(image, P["blur_sigma"])
    img_mb = _motion_blur(image, P["motion_dir"])
    image = _select(P["noise"], _pick(P["noise_pick"], [img_gn, img_gb, img_mb]), image)

    # ---- salt, then pepper ----
    amount = _per_image(P["sp_amount"], 3)
    do_sp = P["saltpepper"][:, None, None]
    salt = (do_sp & (P["sp_u"] < amount / 2))[..., None]
    pepper = (do_sp & (P["sp_u"] > 1.0 - amount / 2))[..., None]
    image = torch.where(salt, 1.0, image)
    image = torch.where(pepper, 0.0, image)

    # ---- ISO noise ----
    iso = image + _per_image(P["iso_intensity"] * 0.1) \
        * torch.sqrt(torch.clamp_min(_luma(image), 1e-4))[..., None] * P["iso_noise"]
    image = _select(P["iso"], torch.clamp(iso, 0, 1), image)

    # ---- OneOf lighting: shadow / sun flare / fog ----
    field = _upsample_grid(P["light_field"][:, None], h, w)[:, 0]
    shadow_mask = torch.clamp((field - 0.5) * 2.0, 0.0, 1.0)[..., None]
    img_shadow = image * (1.0 - 0.5 * shadow_mask)
    flare_mask = torch.clamp((field - 0.6) * 2.5, 0.0, 1.0)[..., None]
    img_flare = torch.clamp(image + 0.6 * flare_mask, 0, 1)
    fog = _per_image(P["fog"])
    img_fog = image * (1 - fog) + fog
    return _select(P["lighting"], _pick(P["lighting_pick"], [img_shadow, img_flare, img_fog]),
                   image)


def augment_batch(generator: torch.Generator, images01: torch.Tensor, masks: torch.Tensor,
                  class_indices: torch.Tensor, policy=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw from ``generator`` and apply: images (B, h, w, 3) float32 in
    [0, 1], masks (B, h, w), ``class_indices`` (B,) 0 = cat, 1 = dog, all on
    one device. ``policy``: a POLICY-style table or its ``policy_arrays``."""
    h, w = images01.shape[1:3]
    return apply_params(sample_params(generator, class_indices, policy, h, w), images01, masks)


def mask_classes(masks: torch.Tensor) -> torch.Tensor:
    """Class ids (B,) from mask contents: 0 (cat) where the mask holds a 1,
    else 1 (dog), as the offline router ``class_index_for`` decides."""
    return torch.where(masks.eq(1).flatten(1).any(1), 0, 1)


def _augment_by_mask_class(generator, images, masks, policy):
    """The online path's core: uint8 pixels (or [0, 1] floats) and masks on
    one device, classes from the masks, the policy applied; [0, 1] pixels."""
    return augment_batch(generator, normalize_image(images, mode="unit"), masks,
                         mask_classes(masks), policy)


def _imagenet(img: torch.Tensor) -> torch.Tensor:
    mean, std = _imagenet_stats(img.device)
    return (img - mean) / std


def augment_and_normalize(generator: torch.Generator, images: torch.Tensor,
                          masks: torch.Tensor, policy=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The online training path: augment (classes from the masks: 1 present →
    cat), then ImageNet-normalize. ``images`` (B, h, w, 3) uint8 or float in
    [0, 1] and ``masks`` (B, h, w) on the device of ``generator``."""
    img, m = _augment_by_mask_class(generator, images, masks, policy)
    return _imagenet(img), m


def augment_and_normalize_with_clip(
    generator: torch.Generator, images: torch.Tensor, masks: torch.Tensor,
    clip_size: int = 224, policy=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``augment_and_normalize`` that also returns the CLIP view of the
    AUGMENTED pixels: their bilinear resize to ``clip_size``², ImageNet-
    normalized (the reference's quirk: ImageNet statistics, not CLIP's)."""
    img, m = _augment_by_mask_class(generator, images, masks, policy)
    clip_img = resize_bilinear(img, (clip_size, clip_size))
    return _imagenet(img), m, _imagenet(clip_img)
