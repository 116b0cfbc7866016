"""Weights into and out of the port's UNet.

The port's module tree owns exactly the reference torch UNet's state-dict
keys, which the JAX package also writes (``cli export_torch``):

    encoder_stages.{i}.block.{idx}.weight/bias     Conv2d / InstanceNorm
    decoder_stages.{d}.conv_block.block.{idx}....
    segmentation_output.weight/bias                (1x1 head)

Inside each ``block`` every conv occupies [Conv2d, InstanceNorm, LeakyReLU(,
dropout)], so the conv of unit j sits at j*step and its norm at j*step+1,
with step 4 when the stage's dropout rate is > 0, else 3.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np
import torch

from unet_implementations_tpu_torch.models.blocks import N_CONVS
from unet_implementations_tpu_torch.models.unet import UNet, unet_6stage


def _conv_oihw(kernel) -> torch.Tensor:
    """HWIO -> torch Conv2d (out, in, kh, kw)."""
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(kernel, np.float32), (3, 2, 0, 1))))


def _vec(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v, np.float32))


def params_from_jax(params: Dict, model: UNet) -> Dict[str, torch.Tensor]:
    """The JAX ``UNet`` params tree (nested dict of arrays) as the port's
    float32 ``state_dict``; load it with ``model.load_state_dict(sd)``."""
    sd: Dict[str, torch.Tensor] = {}

    def emit_block(prefix: str, tree: Dict, dropout: float):
        step = 4 if dropout > 0 else 3
        for j in range(N_CONVS):
            conv_idx, norm_idx = j * step, j * step + 1
            sd[f"{prefix}.block.{conv_idx}.weight"] = _conv_oihw(tree[f"conv_{j}"]["kernel"])
            sd[f"{prefix}.block.{conv_idx}.bias"] = _vec(tree[f"conv_{j}"]["bias"])
            sd[f"{prefix}.block.{norm_idx}.weight"] = _vec(tree[f"norm_{j}"]["scale"])
            sd[f"{prefix}.block.{norm_idx}.bias"] = _vec(tree[f"norm_{j}"]["bias"])

    for i in range(model.n_stages):
        emit_block(f"encoder_stages.{i}", params[f"encoder_{i}"],
                   model.encoder_dropout_rates[i])
    for d in range(model.n_stages - 1):
        emit_block(f"decoder_stages.{d}.conv_block", params[f"decoder_{d}"]["conv_block"],
                   model.decoder_dropout_rates[d])
    sd["segmentation_output.weight"] = _conv_oihw(params["head"]["kernel"])
    sd["segmentation_output.bias"] = _vec(params["head"]["bias"])
    return sd


def save_reference_checkpoint(model: UNet, path) -> None:
    """Write ``model`` as a reference-schema ``.pth`` (epoch / model_state_dict
    / best_dice, float32 CPU tensors), the schema ``cli export_torch`` writes.
    The model has not been trained here, so epoch and best_dice are 0."""
    sd = {k: v.detach().to("cpu", torch.float32).contiguous()
          for k, v in model.state_dict().items()}
    torch.save({"epoch": 0, "model_state_dict": sd, "best_dice": 0.0}, str(path))


def load_reference_checkpoint(path, device=None, dtype: torch.dtype = torch.bfloat16,
                              **layout) -> UNet:
    """Build ``unet_6stage`` on ``device`` (CUDA unless named) and load a
    reference-schema ``.pth`` (full checkpoint dict or bare state dict)
    strictly. ``layout`` (``s2d_level0``, ``s2d_low_channel_decoders``) goes
    to ``unet_6stage``: one ``.pth`` loads into either layout. Returns the
    model in eval mode."""
    ckpt = torch.load(str(Path(path)), map_location="cpu", weights_only=True)
    sd = ckpt.get("model_state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    model = unet_6stage(dtype=dtype, device=device, **layout)
    model.load_state_dict(sd, strict=True)
    return model.eval()
