"""Random weights from the seed, made on the device in one draw.

Every parameter of a configuration (its names and shapes come from the plain
reference's ``param_shapes``) is a slice of one float32 normal draw from a
``torch.Generator`` on the device, scaled by its kind: conv weights by the
reference's Kaiming fan-out std, sqrt(2 / (k * k * cout)); conv biases by
0.01; InstanceNorm scales 1 + 0.1 z and shifts 0.1 z (random affines, so
that a fault in their handling shows); a kind that is a number is the
std of a plain normal, "one+" a LayerNorm scale 1 + 0.1 z. The same seed
gives the same weights.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from pb.data import generator

SCALES = {"conv_b": 0.01, "norm_w": 0.1, "one+": 0.1, "norm_b": 0.1}


def make(shapes: Dict[str, Tuple[Tuple[int, ...], str]], seed: int, tag: int,
         device: torch.device) -> Dict[str, torch.Tensor]:
    total = sum(math.prod(shape) for shape, _ in shapes.values())
    flat = torch.randn(total, generator=generator(device, seed, tag), device=device)
    out, at = {}, 0
    for name, (shape, kind) in shapes.items():
        n = math.prod(shape)
        z = flat[at:at + n].view(shape)
        at += n
        if isinstance(kind, float):
            out[name] = kind * z
        elif kind == "conv_w":
            out[name] = z * math.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))
        elif kind in ("norm_w", "one+"):
            out[name] = 1.0 + SCALES[kind] * z
        else:
            out[name] = SCALES[kind] * z
    return out
