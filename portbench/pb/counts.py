"""Operations and bytes of the configurations, counted from their widths.

Nothing here looks at what the program launches, so a fold, a fusion or a
removed kernel in a later change cannot move the yardstick. Peaks are the
H100 SXM's published dense rates (NVIDIA's data sheet) at its 700 W limit.
"""

from __future__ import annotations

import math
from typing import Dict

from reference import unet as ref_unet

BF16_FLOPS_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12


def unet_forward_flops(cfg: Dict) -> float:
    """FLOPs (2 a multiply-add) of the convs of one image's forward."""
    return 2.0 * ref_unet.conv_macs(cfg)


def clip_tower_flops(tower: Dict) -> float:
    """FLOPs of one image through the ViT tower (patch embedding, every
    block's products and attention, the projection)."""
    w, p, size = tower["width"], tower["patch_size"], tower["image_size"]
    tokens = (size // p) ** 2 + 1
    per_block = tokens * (4 * w * w + 2 * w * tower["mlp_ratio"] * w) + 2 * tokens * tokens * w
    macs = (tokens - 1) * 3 * p * p * w + tower["layers"] * per_block + w * tower["output_dim"]
    return 2.0 * macs


def step_flops_per_image(cfg: Dict, train: bool) -> float:
    """Model FLOPs of one image: a train step counts the forward three
    times (forward, and the backward's two products); a frozen tower counts
    its forward once."""
    f = unet_forward_flops(cfg) * (3.0 if train else 1.0)
    if cfg.get("clip_tower"):
        f += clip_tower_flops(cfg["clip_tower"])
    return f


def k1_bytes(cfg: Dict, batch: int, itemsize: int = 2) -> int:
    """K1 (InstanceNorm + LeakyReLU) over one forward: each input read once
    and each output written once."""
    return sum(2 * math.prod(s) * itemsize for s in ref_unet.norm_shapes(cfg, batch))


def k1bwd_bytes(cfg: Dict, batch: int, itemsize: int = 2) -> int:
    """K1's backward over one step: x and dy read once, dx written once."""
    return sum(3 * math.prod(s) * itemsize for s in ref_unet.norm_shapes(cfg, batch))
