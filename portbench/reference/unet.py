"""Plain float32 reference of the 6-stage segmentation UNet and its train step.

Written from the published description of the reference Our_UNet and
CLIP_UNet (SURVEY.md section 0: ``Our_UNet/models/unet.py:233-432``,
``CLIP_UNet/models/unet.py:234-618``), in plain ``torch`` with no kernel, and
from the configuration file's widths alone. It imports nothing of the program.

- Each encoder stage: ``n_conv`` x [k x k conv (padding k//2, the stride on
  the first), InstanceNorm (biased variance, eps 1e-5, affine), LeakyReLU
  0.01, channel dropout]. Each decoder: bilinear 2x upsample (half-pixel
  centres, edges clamped), concat [upsampled, skip], the same block. Head:
  1 x 1 conv to the class logits.
- CLIP fusion (``clip_fusion``): after the bottleneck stage, concat [x, the
  (B, clip_dim) features broadcast over the grid], 1 x 1 conv back to the
  bottleneck width, InstanceNorm, LeakyReLU.
- Channel dropout drops whole (image, channel) pairs: one ``torch.rand((B, C))``
  draw per dropout site, in forward order, kept where the draw is below
  1 - rate, kept channels scaled by 1 / (1 - rate).
- Loss: weighted cross-entropy (per-batch inverse-frequency class weights,
  the ignore label 255) plus soft Dice (per image and class over valid
  pixels, smooth 1e-5), all in float32.
- Optimizer: SGD with Nesterov momentum and L2 weight decay added to the
  gradient (the first momentum buffer is the gradient itself).

``precision="fp8"`` is the control: every conv's operands are rounded to
float8 e5m2 as the program's own fp8 conv mode rounds them (sums in
float32, gradients passing through in float32), the nearest precision
below the configuration's bfloat16.

A batch's loss is a sum over its images once the class weights and the CE
denominator (functions of the masks alone) are known, so a step runs its
forward and backward in blocks of images and adds up the gradients: the
result is the full batch's step at any block size.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
EPS = 1e-5
SLOPE = 0.01
IGNORE = 255
SMOOTH = 1e-5
# Images a block of the reference's forward and backward: it bounds the
# reference's memory, and the result is the same at any block size.
BLOCK = 16


def set_exact_float32() -> None:
    """float32 products without TF32 (cuDNN and cuBLAS would use it)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _block_keys(prefix: str, n_conv: int, rate: float) -> List[Tuple[str, str]]:
    step = 4 if rate > 0 else 3
    return [(f"{prefix}.block.{u * step}", f"{prefix}.block.{u * step + 1}")
            for u in range(n_conv)]


def layout(cfg: Dict) -> Dict:
    """The stages of ``cfg``: for each encoder and decoder its (conv, norm)
    key prefixes, widths, stride and dropout rate."""
    feats, strides = cfg["features_per_stage"], cfg["strides"]
    n, k = len(feats), cfg["kernel_size"]
    enc, cin = [], cfg["in_channels"]
    for i in range(n):
        rate = cfg["encoder_dropout"][i]
        enc.append({"keys": _block_keys(f"encoder_stages.{i}", cfg["n_conv_per_stage"], rate),
                    "cin": cin, "cout": feats[i], "stride": strides[i], "rate": rate})
        cin = feats[i]
    dec = []
    for d in range(n - 1):
        f = feats[n - 2 - d]
        rate = cfg["decoder_dropout"][d]
        dec.append({"keys": _block_keys(f"decoder_stages.{d}.conv_block",
                                        cfg["n_conv_per_stage_decoder"], rate),
                    "cin": cin + f, "cout": f, "stride": 1, "rate": rate})
        cin = f
    return {"encoders": enc, "decoders": dec, "kernel_size": k, "head_in": cin}


def param_shapes(cfg: Dict) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """Every parameter of ``cfg``'s model: name -> (shape, kind), kind one of
    conv_w, conv_b, norm_w, norm_b. The names are the reference torch
    model's state-dict keys."""
    lay, k = layout(cfg), cfg["kernel_size"]
    out: Dict[str, Tuple[Tuple[int, ...], str]] = {}

    def block(stage):
        cin = stage["cin"]
        for conv, norm in stage["keys"]:
            out[f"{conv}.weight"] = ((stage["cout"], cin, k, k), "conv_w")
            out[f"{conv}.bias"] = ((stage["cout"],), "conv_b")
            out[f"{norm}.weight"] = ((stage["cout"],), "norm_w")
            out[f"{norm}.bias"] = ((stage["cout"],), "norm_b")
            cin = stage["cout"]

    for stage in lay["encoders"]:
        block(stage)
    for stage in lay["decoders"]:
        block(stage)
    out["segmentation_output.weight"] = ((cfg["num_classes"], lay["head_in"], 1, 1), "conv_w")
    out["segmentation_output.bias"] = ((cfg["num_classes"],), "conv_b")
    if cfg.get("clip_fusion"):
        w, c = cfg["features_per_stage"][-1], cfg["clip_dim"]
        out["clip_fusion_conv.0.weight"] = ((w, w + c, 1, 1), "conv_w")
        out["clip_fusion_conv.0.bias"] = ((w,), "conv_b")
        out["clip_fusion_conv.1.weight"] = ((w,), "norm_w")
        out["clip_fusion_conv.1.bias"] = ((w,), "norm_b")
    return out


def dropout_sites(cfg: Dict) -> List[Tuple[int, float]]:
    """(channels, rate) of each dropout draw, in forward order."""
    lay = layout(cfg)
    return [(s["cout"], s["rate"]) for s in lay["encoders"] + lay["decoders"]
            for _ in s["keys"] if s["rate"] > 0]


def draw_keep_masks(cfg: Dict, batch: int, generator: torch.Generator) -> List[torch.Tensor]:
    """The (batch, C) keep masks of one training forward, drawn in forward
    order from ``generator``."""
    return [torch.rand((batch, c), generator=generator, device=generator.device) < 1.0 - rate
            for c, rate in dropout_sites(cfg)]


def normalize(pixels: torch.Tensor) -> torch.Tensor:
    """uint8 (B, H, W, 3) -> ImageNet-normalized float32."""
    mean = torch.tensor(IMAGENET_MEAN, device=pixels.device)
    std = torch.tensor(IMAGENET_STD, device=pixels.device)
    return (pixels.to(torch.float32) / 255.0 - mean) / std


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e5m2, as the program's own fp8 conv mode
    casts every conv operand (``UNET_TPU_CONV_FP8``, its default dtype, no
    scale), back in float32. The gradient passes straight through, in
    float32."""
    q = t.detach().to(torch.float8_e5m2).to(torch.float32)
    return t + (q - t).detach()


def _q(t: torch.Tensor, precision: str) -> torch.Tensor:
    return fp8_round(t) if precision == "fp8" else t


def conv(x, w, b, stride: int, pad: int, precision: str):
    return F.conv2d(_q(x, precision), _q(w, precision), b, stride, pad)


def norm_act(x, w, b):
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = ((x - mean) ** 2).mean(dim=(2, 3), keepdim=True)
    y = (x - mean) * torch.rsqrt(var + EPS) * w[None, :, None, None] + b[None, :, None, None]
    return F.leaky_relu(y, SLOPE)


def _stage(x, p, stage, k: int, keep: Optional[List[torch.Tensor]], precision: str):
    for u, (cname, nname) in enumerate(stage["keys"]):
        x = conv(x, p[f"{cname}.weight"], p[f"{cname}.bias"],
                 stage["stride"] if u == 0 else 1, k // 2, precision)
        x = norm_act(x, p[f"{nname}.weight"], p[f"{nname}.bias"])
        if keep is not None and stage["rate"] > 0:
            m = keep.pop(0)
            x = torch.where(m[:, :, None, None], x / (1.0 - stage["rate"]), torch.zeros_like(x))
    return x


def forward(cfg: Dict, p: Dict[str, torch.Tensor], image: torch.Tensor,
            keep: Optional[Sequence[torch.Tensor]] = None,
            clip_features: Optional[torch.Tensor] = None,
            precision: str = "float32") -> torch.Tensor:
    """(B, H, W, 3) normalized float32 -> (B, H, W, classes) float32 logits.
    ``keep``: the dropout keep masks of these images (training), or None
    (evaluation)."""
    lay, k = layout(cfg), cfg["kernel_size"]
    keep = None if keep is None else list(keep)
    x = image.permute(0, 3, 1, 2)
    skips = []
    for i, stage in enumerate(lay["encoders"]):
        x = _stage(x, p, stage, k, keep, precision)
        if i < len(lay["encoders"]) - 1:
            skips.append(x)
    if cfg.get("clip_fusion") and clip_features is not None:
        b, _, h, w = x.shape
        cf = clip_features.to(torch.float32)[:, :, None, None].expand(b, -1, h, w)
        x = conv(torch.cat([x, cf], 1), p["clip_fusion_conv.0.weight"],
                 p["clip_fusion_conv.0.bias"], 1, 0, precision)
        x = norm_act(x, p["clip_fusion_conv.1.weight"], p["clip_fusion_conv.1.bias"])
    for stage in lay["decoders"]:
        skip = skips.pop()
        x = F.interpolate(x, size=skip.shape[2:], mode="bilinear", align_corners=False)
        x = _stage(torch.cat([x, skip], 1), p, stage, k, keep, precision)
    x = conv(x, p["segmentation_output.weight"], p["segmentation_output.bias"], 1, 0, precision)
    return x.permute(0, 2, 3, 1)


def batch_constants(mask: torch.Tensor, classes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(class weights (C,), CE denominator) of a whole batch of masks."""
    valid = (mask != IGNORE)
    counts = torch.stack([((mask == c) & valid).sum() for c in range(classes)]).to(torch.float64)
    total = valid.sum().to(torch.float64)
    counts = torch.where(counts == 0, torch.ones_like(counts), counts)
    w = total / counts
    w = (w * (classes / w.sum())).to(torch.float32)
    pixel_w = w[mask.long().clamp(max=classes - 1)] * (valid & (mask < classes))
    return w, pixel_w.to(torch.float64).sum().clamp(min=1e-12).to(torch.float32)


def loss_part(logits: torch.Tensor, mask: torch.Tensor, weights: torch.Tensor,
              denom: torch.Tensor, batch: int, w_ce: float = 1.0,
              w_dice: float = 1.0) -> torch.Tensor:
    """These images' share of the batch's loss, without Dice's constant
    ``w_dice``: CE numerator / the batch's denominator, minus their Dice
    over (classes x batch)."""
    c = logits.shape[-1]
    valid = (mask != IGNORE)
    onehot = F.one_hot(mask.long().clamp(max=c), c + 1)[..., :c].to(torch.float32)
    onehot = onehot * valid[..., None]
    logp = torch.log_softmax(logits, dim=-1)
    nll = -(logp * onehot).sum(-1)
    pixel_w = (onehot * weights).sum(-1)
    ce = (nll * pixel_w).sum() / denom
    probs = torch.softmax(logits, dim=-1) * valid[..., None]
    inter = (probs * onehot).sum(dim=(1, 2))
    union = probs.sum(dim=(1, 2)) + onehot.sum(dim=(1, 2))
    dice = (2.0 * inter + SMOOTH) / (union + SMOOTH)
    return w_ce * ce - w_dice * dice.sum() / (c * batch)


def train_steps(cfg: Dict, params: Dict[str, torch.Tensor], batches: Sequence[Dict],
                hp: Dict, precision: str = "float32",
                keep_rows: Optional[int] = None, block: int = BLOCK) -> Dict:
    """Run ``len(batches)`` SGD-Nesterov steps of the full-batch objective
    from ``params`` (not modified). Each batch: ``{"image": uint8 (B, H, W,
    3), "mask": (B, H, W), "generator": the step's dropout generator, and
    "clip_features": (B, D) or absent}``, all on one device.

    ``keep_rows``: a planted fault, the step computed on the first rows
    only (its loss the mean over them).

    Returns ``{"losses": [float], "grad1": {name: the first step's gradient
    as the optimizer takes it (weight decay added)}, "raw_grad1": {name:
    the first step's gradient}, "params": {name: after the last step}}``.
    """
    p = {k: v.detach().clone().to(torch.float32).requires_grad_(True) for k, v in params.items()}
    mom, wd, lr = hp["momentum"], hp["weight_decay"], hp["lr"]
    buf: Dict[str, torch.Tensor] = {}
    out: Dict = {"losses": []}
    classes = cfg["num_classes"]
    for s, b in enumerate(batches):
        image, mask = b["image"], b["mask"]
        feats = b.get("clip_features")
        keep = b["keep"] if "keep" in b else draw_keep_masks(cfg, image.shape[0], b["generator"])
        if keep_rows is not None:
            image, mask, keep = image[:keep_rows], mask[:keep_rows], [m[:keep_rows] for m in keep]
            feats = None if feats is None else feats[:keep_rows]
        n = image.shape[0]
        weights, denom = batch_constants(mask, classes)
        for t in p.values():
            t.grad = None
        total = torch.zeros((), dtype=torch.float64, device=image.device)
        for lo in range(0, n, block):
            hi = min(lo + block, n)
            logits = forward(cfg, p, normalize(image[lo:hi]) if image.dtype == torch.uint8
                             else image[lo:hi], [m[lo:hi] for m in keep],
                             None if feats is None else feats[lo:hi], precision)
            part = loss_part(logits, mask[lo:hi], weights, denom, n,
                             hp.get("weight_ce", 1.0), hp.get("weight_dice", 1.0))
            part.backward()
            total += part.detach().to(torch.float64)
        out["losses"].append(float(total) + hp.get("weight_dice", 1.0))
        with torch.no_grad():
            for name, t in p.items():
                g = t.grad if t.grad is not None else torch.zeros_like(t)
                d = g + wd * t
                if s == 0:
                    out.setdefault("raw_grad1", {})[name] = g.clone()
                    out.setdefault("grad1", {})[name] = d.clone()
                buf[name] = d.clone() if name not in buf else mom * buf[name] + d
                t -= lr * (d + mom * buf[name])
    out["params"] = {k: v.detach() for k, v in p.items()}
    return out


@torch.no_grad()
def predict_logits(cfg: Dict, params: Dict[str, torch.Tensor], pixels: torch.Tensor,
                   precision: str = "float32") -> torch.Tensor:
    """Evaluation-mode logits (B, H, W, classes) float32 of uint8 pixels, in
    blocks of images."""
    p = {k: v.to(torch.float32) for k, v in params.items()}
    return torch.cat([forward(cfg, p, normalize(pixels[lo:lo + BLOCK]), None, None, precision)
                      for lo in range(0, pixels.shape[0], BLOCK)])


def nearest_index(n_in: int, n_out: int, device) -> torch.Tensor:
    """Source index of each output row of a nearest resize: floor(i * in / out)."""
    i = torch.arange(n_out, dtype=torch.float64, device=device)
    return torch.clamp(torch.floor(i * (n_in / n_out)).to(torch.int64), 0, n_in - 1)


def conv_macs(cfg: Dict) -> float:
    """Multiply-adds of every conv of one image's forward at ``cfg``'s size."""
    lay, k = layout(cfg), cfg["kernel_size"]
    size = cfg["image_size"]
    macs, res = 0.0, size
    sizes = []
    for stage in lay["encoders"]:
        res = res // stage["stride"]
        sizes.append(res)
        cin = stage["cin"]
        for _ in stage["keys"]:
            macs += res * res * k * k * cin * stage["cout"]
            cin = stage["cout"]
    if cfg.get("clip_fusion"):
        w = cfg["features_per_stage"][-1]
        macs += sizes[-1] ** 2 * (w + cfg["clip_dim"]) * w
    for d, stage in enumerate(lay["decoders"]):
        res = sizes[len(sizes) - 2 - d]
        cin = stage["cin"]
        for _ in stage["keys"]:
            macs += res * res * k * k * cin * stage["cout"]
            cin = stage["cout"]
    macs += size * size * lay["head_in"] * cfg["num_classes"]
    return float(macs)


def norm_shapes(cfg: Dict, batch: int) -> List[Tuple[int, int, int, int]]:
    """(B, H, W, C) of the input of every InstanceNorm of one forward."""
    lay, size = layout(cfg), cfg["image_size"]
    res, sizes, out = size, [], []
    for stage in lay["encoders"]:
        res = res // stage["stride"]
        sizes.append(res)
        out += [(batch, res, res, stage["cout"])] * len(stage["keys"])
    if cfg.get("clip_fusion"):
        out.append((batch, sizes[-1], sizes[-1], cfg["features_per_stage"][-1]))
    for d, stage in enumerate(lay["decoders"]):
        r = sizes[len(sizes) - 2 - d]
        out += [(batch, r, r, stage["cout"])] * len(stage["keys"])
    return out
