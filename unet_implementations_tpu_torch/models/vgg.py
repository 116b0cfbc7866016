"""VGG16 feature extractor for the perceptual loss.

Counterpart of ``unet_implementations_tpu/models/vgg.py``. The reference's
``PerceptualLoss`` builds torchvision VGG16 with ``weights=None``, that is with
random weights, and so does the JAX package by default: a Kaiming fan-out
normal init (std = sqrt(2 / (9·Cout)), zero bias), here drawn from a given
generator. ``load_torch_vgg16_weights`` loads a torchvision VGG16
``state_dict`` (pretrained weights, where a user has the file) instead.

Feature taps: relu1_2, relu2_2, relu3_3, relu4_3 (the reference defaults).
Input and outputs are NHWC, as in JAX; parameters are float32 and each conv
casts them to the compute dtype at the call.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from unet_implementations_tpu_torch import default_device
from unet_implementations_tpu_torch.models.blocks import kaiming_conv, nchw, nhwc, plain_conv2d

# VGG16 conv plan: (conv count, channels) per block.
VGG16_PLAN = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))
# torchvision's ``features.{i}`` index of each conv, in order.
TORCHVISION_CONV_INDICES = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
# tap name -> (block index, conv index within the block)
TAPS = {"relu1_2": (0, 1), "relu2_2": (1, 1), "relu3_3": (2, 2), "relu4_3": (3, 2)}
DEFAULT_TAPS = ("relu1_2", "relu2_2", "relu3_3", "relu4_3")


class VGG16Features(nn.Module):
    """The VGG16 trunk up to the last wanted tap; ``forward`` returns the
    tapped maps. Convs are named ``conv{block}_{i}`` as the JAX params are."""

    def __init__(self, taps: Sequence[str] = DEFAULT_TAPS, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.taps = tuple(taps)
        self.dtype = dtype
        self.wanted = {TAPS[t]: t for t in self.taps}
        self.last_block = max(b for b, _ in self.wanted)
        convs = {}
        cin = 3
        for b, (n_convs, ch) in enumerate(VGG16_PLAN[:self.last_block + 1]):
            for i in range(n_convs):
                convs[f"conv{b + 1}_{i + 1}"] = kaiming_conv(cin, ch, 3, 1, generator)
                cin = ch
        self.convs = nn.ModuleDict(convs)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        x = nchw(x.to(self.dtype)).contiguous(memory_format=torch.channels_last)
        for b, (n_convs, _) in enumerate(VGG16_PLAN[:self.last_block + 1]):
            for i in range(n_convs):
                x = F.relu(plain_conv2d(x, self.convs[f"conv{b + 1}_{i + 1}"]))
                if (b, i) in self.wanted:
                    out[self.wanted[(b, i)]] = nhwc(x)
            if b < self.last_block:
                x = F.max_pool2d(x, 2, 2)
        return out


def make_features_fn(generator: Optional[torch.Generator] = None,
                     taps: Sequence[str] = DEFAULT_TAPS, dtype: torch.dtype = torch.float32,
                     device=None) -> VGG16Features:
    """The frozen extractor x -> {tap: features} for ``ops.losses.
    perceptual_loss`` (one trunk pass gives every tap), with random weights
    from ``generator``, on ``device`` (CUDA unless named). Its parameters
    take no gradient; the gradient reaches x."""
    model = VGG16Features(taps, dtype, generator).to(default_device(device))
    return model.eval().requires_grad_(False)


def vgg_params_from_jax(params: Dict, model: VGG16Features) -> Dict[str, torch.Tensor]:
    """The JAX ``VGG16Features`` params tree as ``model``'s float32 state
    dict (HWIO kernels -> (out, in, kh, kw))."""
    sd = {}
    for name in model.convs:
        kernel = np.asarray(params[name]["kernel"], np.float32)
        sd[f"convs.{name}.weight"] = torch.from_numpy(
            np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))
        sd[f"convs.{name}.bias"] = torch.from_numpy(np.array(params[name]["bias"], np.float32))
    return sd


def load_torch_vgg16_weights(source: str | Path | Mapping[str, torch.Tensor],
                             model: VGG16Features) -> VGG16Features:
    """Load a torchvision VGG16 ``state_dict`` (``features.{i}.weight`` and
    ``.bias`` of its 13 convs; a dict, or a file that ``torch.load`` reads
    with ``weights_only=True`` on the CPU) into ``model``'s convs, strictly:
    every conv the model's taps use must be there. Returns the model, its
    float32 parameters on its device."""
    sd = (torch.load(str(source), map_location="cpu", weights_only=True)
          if isinstance(source, (str, Path)) else source)
    names = [f"conv{b + 1}_{i + 1}" for b, (n, _) in enumerate(VGG16_PLAN) for i in range(n)]
    device = next(model.parameters()).device
    ours = {}
    for name, idx in zip(names, TORCHVISION_CONV_INDICES):
        if name not in model.convs:
            continue
        for part in ("weight", "bias"):
            key = f"features.{idx}.{part}"
            if key not in sd:
                raise KeyError(f"{key} ({name}) is missing from the VGG16 state dict")
            ours[f"convs.{name}.{part}"] = sd[key].to(device=device, dtype=torch.float32)
    model.load_state_dict(ours, strict=True)
    return model
