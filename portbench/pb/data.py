"""Inputs from the seed: synthetic pet images and masks, request sizes, and
the seeds of each step's random draws.

``pets`` is the generator of ``unet_implementations_tpu_torch/data/
synthetic.py::synthetic_sample`` (an elliptical cat (1) or dog (2) with a 255
border ring on a textured background, the Oxford-IIIT Pet trimap format),
written for a whole batch at once on the device from a ``torch.Generator``,
so that set-up draws a batch in a few large calls instead of image by image
on the host. It draws the same distribution as the original, not the same
values. ``mix_seed`` copies the ``SeedSequence`` mixing of the program's
``training/loop.py::dropout_generator`` and
``recipes/common.py::augment_generator``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

# The object colours of synthetic_sample: cat, dog.
COLOURS = ((0.85, 0.3, 0.25), (0.25, 0.35, 0.85))


def mix_seed(*parts: int) -> int:
    """A 64-bit seed from whole numbers of any size (numpy's SeedSequence
    over their 32-bit words)."""
    words: List[int] = []
    for p in parts:
        p = int(p)
        words += [p & 0xFFFFFFFF, (p >> 32) & 0xFFFFFFFF]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0])


def generator(device: torch.device, *parts: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(mix_seed(*parts))


def pets(gen: torch.Generator, batch: int, size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(images (B, S, S, 3) uint8, masks (B, S, S) uint8) on ``gen``'s
    device."""
    dev = gen.device
    u = torch.rand((batch, 5), generator=gen, device=dev)
    cls = 1 + (u[:, 0] < 0.5).to(torch.int64)
    cy, cx = (0.3 + 0.4 * u[:, 1]) * size, (0.3 + 0.4 * u[:, 2]) * size
    ry, rx = (0.15 + 0.15 * u[:, 3]) * size, (0.15 + 0.15 * u[:, 4]) * size
    axis = torch.arange(size, device=dev, dtype=torch.float32)
    dist = (((axis[None, :, None] - cy[:, None, None]) / ry[:, None, None]) ** 2
            + ((axis[None, None, :] - cx[:, None, None]) / rx[:, None, None]) ** 2)
    inside, border = dist <= 1.0, (dist > 1.0) & (dist <= 1.25)
    mask = torch.where(inside, cls[:, None, None], torch.zeros_like(cls)[:, None, None])
    mask = torch.where(border, torch.full_like(mask, 255), mask).to(torch.uint8)
    noise = torch.randn((batch, size, size, 3), generator=gen, device=dev)
    colour = torch.tensor(COLOURS, device=dev)[cls - 1][:, None, None, :]
    img = torch.where(inside[..., None], colour + 0.05 * noise, 0.4 + 0.08 * noise)
    pixels = torch.round(img.clamp(0.0, 1.0) * 255.0).to(torch.uint8)
    return pixels, mask


def ring(seed: int, n: int, batch: int, size: int, device: torch.device,
         pinned: bool) -> List[Dict[str, torch.Tensor]]:
    """``n`` distinct batches ``{"image", "mask"}``, drawn on ``device``; with
    ``pinned`` moved to page-locked host memory, as a loader's batches
    arrive."""
    gen = generator(device, seed, 1)
    out = []
    for _ in range(n):
        image, mask = pets(gen, batch, size)
        if pinned:
            image, mask = image.cpu().pin_memory(), mask.cpu().pin_memory()
        out.append({"image": image, "mask": mask})
    return out


def original_sizes(seed: int, batch: int, mix: Sequence[Dict]) -> List[Tuple[int, int]]:
    """(h, w) of each image of a request: the multiset that ``mix`` fixes
    (entries ``{"h", "w", "share"}``; shares of the batch, the remainder
    going to the first entry), in an order drawn from ``seed``. Every seed
    has the same sizes."""
    counts = [int(round(m["share"] * batch)) for m in mix]
    counts[0] += batch - sum(counts)
    sizes = [(m["h"], m["w"]) for m, c in zip(mix, counts) for _ in range(c)]
    order = np.random.default_rng(mix_seed(seed, 2)).permutation(batch)
    return [sizes[i] for i in order]
