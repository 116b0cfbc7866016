"""Plain float32 reference of the frozen CLIP ViT image tower, and the
reference's inputs of an online-augmented CLIP_UNet training cell.

The tower follows the OpenAI CLIP visual transformer (Radford et al. 2021,
github.com/openai/CLIP, ``model.py::VisionTransformer``): a patch-embedding
conv, the class token and positional embedding, ``ln_pre``, pre-LN residual
blocks (multi-head self-attention, then an MLP with QuickGELU), ``ln_post``
on the class token, and the projection. Parameter names are the OpenAI
checkpoint's ``visual.*`` names without the prefix.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from reference import augment as ref_augment
from reference import unet as ref_unet

LN_EPS = 1e-5


def param_shapes(tower: Dict) -> Dict[str, Tuple[Tuple[int, ...], object]]:
    """name -> (shape, kind) of the tower's parameters (see ``pb/weights.py``
    for the kinds), with the initial scales of OpenAI's tower."""
    w, p, heads = tower["width"], tower["patch_size"], tower["heads"]
    grid, layers, hidden = tower["image_size"] // p, tower["layers"], tower["mlp_ratio"] * w
    out: Dict[str, Tuple[Tuple[int, ...], object]] = {
        "conv1.weight": ((w, 3, p, p), float((3 * p * p) ** -0.5)),
        "class_embedding": ((w,), 0.02),
        "positional_embedding": ((grid * grid + 1, w), 0.01),
        "ln_pre.weight": ((w,), "one+"), "ln_pre.bias": ((w,), "norm_b"),
    }
    for i in range(layers):
        b = f"transformer.resblocks.{i}."
        out.update({
            b + "attn.in_proj_weight": ((3 * w, w), float(w ** -0.5)),
            b + "attn.in_proj_bias": ((3 * w,), 0.01),
            b + "attn.out_proj.weight": ((w, w), float(w ** -0.5)),
            b + "attn.out_proj.bias": ((w,), 0.01),
            b + "ln_1.weight": ((w,), "one+"), b + "ln_1.bias": ((w,), "norm_b"),
            b + "mlp.c_fc.weight": ((hidden, w), float((2 * w) ** -0.5)),
            b + "mlp.c_fc.bias": ((hidden,), 0.01),
            b + "mlp.c_proj.weight": ((w, hidden), float(w ** -0.5 * (2 * layers) ** -0.5)),
            b + "mlp.c_proj.bias": ((w,), 0.01),
            b + "ln_2.weight": ((w,), "one+"), b + "ln_2.bias": ((w,), "norm_b"),
        })
    out.update({"ln_post.weight": ((w,), "one+"), "ln_post.bias": ((w,), "norm_b"),
                "proj": ((w, tower["output_dim"]), float(w ** -0.5))})
    return out


def _q(t: torch.Tensor, precision: str) -> torch.Tensor:
    return ref_unet.fp8_round(t) if precision == "fp8" else t


def _linear(x, w, b, precision):
    return F.linear(_q(x, precision), _q(w, precision), b)


@torch.no_grad()
def tower(t: Dict, p: Dict[str, torch.Tensor], images: torch.Tensor,
          precision: str = "float32") -> torch.Tensor:
    """(B, S, S, 3) normalized float32 -> (B, output_dim) float32."""
    w, heads = t["width"], t["heads"]
    x = F.conv2d(_q(images.permute(0, 3, 1, 2), precision), _q(p["conv1.weight"], precision),
                 stride=t["patch_size"])
    b = x.shape[0]
    x = x.flatten(2).transpose(1, 2)
    x = torch.cat([p["class_embedding"].expand(b, 1, -1), x], 1) + p["positional_embedding"]
    x = F.layer_norm(x, (w,), p["ln_pre.weight"], p["ln_pre.bias"], LN_EPS)
    hd = w // heads
    for i in range(t["layers"]):
        k = f"transformer.resblocks.{i}."
        y = F.layer_norm(x, (w,), p[k + "ln_1.weight"], p[k + "ln_1.bias"], LN_EPS)
        qkv = _linear(y, p[k + "attn.in_proj_weight"], p[k + "attn.in_proj_bias"], precision)
        q, kk, v = (z.reshape(b, -1, heads, hd).transpose(1, 2) for z in qkv.split(w, -1))
        att = torch.softmax(_q(q / math.sqrt(hd), precision) @ _q(kk, precision).transpose(-1, -2),
                            -1)
        y = (_q(att, precision) @ _q(v, precision)).transpose(1, 2).reshape(b, -1, w)
        x = x + _linear(y, p[k + "attn.out_proj.weight"], p[k + "attn.out_proj.bias"], precision)
        y = F.layer_norm(x, (w,), p[k + "ln_2.weight"], p[k + "ln_2.bias"], LN_EPS)
        y = _linear(y, p[k + "mlp.c_fc.weight"], p[k + "mlp.c_fc.bias"], precision)
        y = y * torch.sigmoid(1.702 * y)
        x = x + _linear(y, p[k + "mlp.c_proj.weight"], p[k + "mlp.c_proj.bias"], precision)
    x = F.layer_norm(x[:, 0], (w,), p["ln_post.weight"], p["ln_post.bias"], LN_EPS)
    return _q(x, precision) @ _q(p["proj"], precision)


def augment_generator(seed: int, epoch: int, i: int, device) -> torch.Generator:
    """The draws of batch ``i`` of ``epoch``: a copy of the program's
    ``recipes/common.py::augment_generator`` seeding (rank 0)."""
    mixed = np.random.SeedSequence([(seed + 7) & 0xFFFFFFFF, epoch & 0xFFFFFFFF,
                                    i & 0xFFFFFFFF])
    return torch.Generator(device=device).manual_seed(int(mixed.generate_state(1, np.uint64)[0]))


def reference_batches(cell, seed: int, device: torch.device,
                      precision: str = "float32") -> List[Dict]:
    """The first three steps' batches of a CLIP cell, made again from the
    seed: the ring's batch, augmented by the frozen copy with the step's
    draws, its 224-pixel view through the reference tower, and the dropout
    keep masks."""
    from pb import data, weights
    from pb.drivers.train import SETUP_STEPS, step_generator

    cfg, tr = cell.config, cell.traffic
    t = cfg["clip_tower"]
    tower_params = weights.make(param_shapes(t), seed, 4, device)
    aug_seed = data.mix_seed(seed, 5) & 0x7FFFFFFF
    ring = data.ring(data.mix_seed(seed, 0), SETUP_STEPS, tr["batch"], cfg["image_size"],
                     device, pinned=False)
    tables = ref_augment.policy_arrays(None, device)
    out = []
    for k in range(SETUP_STEPS):
        image, mask, view = ref_augment.augment_and_normalize_with_clip(
            augment_generator(aug_seed, 0, k, device), ring[k]["image"], ring[k]["mask"],
            clip_size=t["image_size"], policy=tables)
        out.append({"image": image, "mask": mask,
                    "keep": ref_unet.draw_keep_masks(cfg, tr["batch"],
                                                     step_generator(device, seed, k, 0)),
                    "clip_features": tower(t, tower_params, view, precision)})
    return out
