"""Weights into and out of the port's UNet.

The port's module tree owns exactly the reference torch UNet's state-dict
keys, which the JAX package also writes (``cli export_torch``):

    encoder_stages.{i}.block.{idx}.weight/bias     Conv2d / InstanceNorm
    decoder_stages.{d}.conv_block.block.{idx}....
    segmentation_output.weight/bias                (1x1 head)
    reconstruction_output.0.weight/bias            (autoencoder: 3x3 head)
    clip_fusion_conv.{0,1}.weight/bias             (CLIP_UNet: 1x1 conv, norm)

Inside each ``block`` every conv occupies [Conv2d, InstanceNorm, LeakyReLU(,
dropout)], so the conv of unit j sits at j*step and its norm at j*step+1,
with step 4 when the stage's dropout rate is > 0, else 3.

``clip_params_from_jax`` carries the JAX CLIP tower's weights into the
port's tower (``models/clip.py``), whose keys are the OpenAI visual tower's.

``convert_torch_checkpoint`` (``cli convert``) turns a reference ``.pth`` into
the port's checkpoint directory (``training/checkpoint.py``), and
``export_torch_checkpoint`` (``cli export_torch``) a checkpoint directory back
into a bare reference ``.pth``, each loading the weights strictly into the
model of ``arch``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np
import torch

from unet_implementations_tpu_torch.models.blocks import N_CONVS
from unet_implementations_tpu_torch.models.unet import UNet, autoencoder_6stage, unet_6stage


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
    head = "segmentation_output" if model.head == "segmentation" else "reconstruction_output.0"
    sd[f"{head}.weight"] = _conv_oihw(params["head"]["kernel"])
    sd[f"{head}.bias"] = _vec(params["head"]["bias"])
    if model.clip_fusion and "clip_fusion_conv" in params:
        sd["clip_fusion_conv.0.weight"] = _conv_oihw(params["clip_fusion_conv"]["kernel"])
        sd["clip_fusion_conv.0.bias"] = _vec(params["clip_fusion_conv"]["bias"])
        sd["clip_fusion_conv.1.weight"] = _vec(params["clip_fusion_norm"]["scale"])
        sd["clip_fusion_conv.1.bias"] = _vec(params["clip_fusion_norm"]["bias"])
    return sd


def _t(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v, np.float32))


def clip_params_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """The JAX ``CLIPVisionTransformer`` params tree (nested dict of arrays)
    as the port's tower's float32 ``state_dict`` (the inverse of the JAX
    package's ``load_torch_clip_weights``): the patch conv HWIO -> OIHW; the
    query/key/value kernels (W, heads, head_dim) and biases stacked into
    ``in_proj_weight`` (3W, W) and ``in_proj_bias``; the out kernel (heads,
    head_dim, W) into ``out_proj.weight`` (W, W); Dense (in, out) kernels
    into Linear (out, in) weights."""
    width = np.asarray(params["class_embedding"]).shape[0]
    sd = {
        "conv1.weight": _t(np.transpose(np.asarray(params["patch_embed"]["kernel"]),
                                        (3, 2, 0, 1))),
        "class_embedding": _t(params["class_embedding"]),
        "positional_embedding": _t(params["positional_embedding"]),
        "ln_pre.weight": _t(params["ln_pre"]["scale"]),
        "ln_pre.bias": _t(params["ln_pre"]["bias"]),
    }
    n_layers = len([k for k in params if k.startswith("block_")])
    for i in range(n_layers):
        blk, base = params[f"block_{i}"], f"transformer.resblocks.{i}."
        attn = blk["attn"]
        sd[base + "attn.in_proj_weight"] = _t(np.concatenate(
            [np.asarray(attn[n]["kernel"]).reshape(width, width).T for n in
             ("query", "key", "value")], axis=0))
        sd[base + "attn.in_proj_bias"] = _t(np.concatenate(
            [np.asarray(attn[n]["bias"]).reshape(width) for n in ("query", "key", "value")]))
        sd[base + "attn.out_proj.weight"] = _t(np.asarray(attn["out"]["kernel"])
                                               .reshape(width, width).T)
        sd[base + "attn.out_proj.bias"] = _t(attn["out"]["bias"])
        sd[base + "ln_1.weight"] = _t(blk["ln_1"]["scale"])
        sd[base + "ln_1.bias"] = _t(blk["ln_1"]["bias"])
        sd[base + "mlp.c_fc.weight"] = _t(np.asarray(blk["mlp_fc"]["kernel"]).T)
        sd[base + "mlp.c_fc.bias"] = _t(blk["mlp_fc"]["bias"])
        sd[base + "mlp.c_proj.weight"] = _t(np.asarray(blk["mlp_proj"]["kernel"]).T)
        sd[base + "mlp.c_proj.bias"] = _t(blk["mlp_proj"]["bias"])
        sd[base + "ln_2.weight"] = _t(blk["ln_2"]["scale"])
        sd[base + "ln_2.bias"] = _t(blk["ln_2"]["bias"])
    sd.update({"ln_post.weight": _t(params["ln_post"]["scale"]),
               "ln_post.bias": _t(params["ln_post"]["bias"]),
               "proj": _t(params["proj"])})
    return sd


def save_reference_checkpoint(model: UNet, path) -> None:
    """Write ``model`` as a reference-schema ``.pth`` (epoch / model_state_dict
    / best_dice, float32 CPU tensors), the schema ``cli export_torch`` writes.
    The model has not been trained here, so epoch and best_dice are 0."""
    sd = {k: v.detach().to("cpu", torch.float32).contiguous()
          for k, v in model.state_dict().items()}
    torch.save({"epoch": 0, "model_state_dict": sd, "best_dice": 0.0}, str(path))


def _model_for_arch(arch: str, **kwargs) -> UNet:
    """The reference-trained model of each ``--arch`` of the JAX package's
    ``convert`` / ``export_torch``: the encoder-transfer model is the
    segmentation UNet; ``clip_unet`` is the segmentation UNet with the
    bottleneck fusion at clip_dim 512 (the only variant the reference
    trained)."""
    if arch in ("our_unet", "ae_transfer"):
        return unet_6stage(**kwargs)
    if arch == "ae_recon":
        return autoencoder_6stage(**kwargs)
    if arch == "clip_unet":
        return unet_6stage(clip_fusion=True, **kwargs)
    raise ValueError(f"unknown arch {arch!r}")


def load_reference_checkpoint(path, device=None, dtype: torch.dtype = torch.bfloat16,
                              arch: str = "our_unet", **layout) -> UNet:
    """Build the model of ``arch`` (``our_unet`` | ``ae_transfer``:
    ``unet_6stage``; ``ae_recon``: ``autoencoder_6stage``; ``clip_unet``:
    ``unet_6stage`` with the bottleneck fusion) on ``device`` (CUDA unless
    named) and load a reference-schema ``.pth`` (full checkpoint dict or bare
    state dict) strictly; a ``clip_unet`` file without the four fusion keys
    (the reference builds the fusion lazily) leaves the fusion at its init,
    as the JAX converter does (``UNet.load_reference_state_dict``).
    ``layout`` (``s2d_level0``, ``s2d_low_channel_decoders``) goes to the
    constructor: one ``.pth`` loads into either layout. Returns the model in
    eval mode."""
    ckpt = torch.load(str(Path(path)), map_location="cpu", weights_only=True)
    sd = ckpt.get("model_state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    model = _model_for_arch(arch, dtype=dtype, device=device, **layout)
    return model.load_reference_state_dict(sd).eval()


def convert_torch_checkpoint(torch_path, output_path, arch: str = "our_unet") -> None:
    """A reference ``.pth`` (full checkpoint dict or bare state dict) -> the
    port's checkpoint directory (``model.pth`` + ``meta.json``, as
    ``training/checkpoint.py`` writes and reads), loaded strictly into the
    model of ``arch`` on the CPU on the way. Keeps the file's epoch and best
    metric (``best_dice``, else ``best_loss``) when it has them."""
    from unet_implementations_tpu_torch.training.checkpoint import save_checkpoint

    ckpt = torch.load(str(torch_path), map_location="cpu", weights_only=True)
    sd = ckpt.get("model_state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    model = _model_for_arch(arch, device="cpu").load_reference_state_dict(sd)
    meta = ckpt if isinstance(ckpt, dict) else {}
    save_checkpoint(output_path, model, None, epoch=int(meta.get("epoch", 0)),
                    best_metric=float(meta.get("best_dice", meta.get("best_loss", 0.0))),
                    config={"converted_from": str(torch_path), "arch": arch})


def export_torch_checkpoint(checkpoint_path, output_path, arch: str = "our_unet") -> None:
    """The port's checkpoint directory -> a bare reference-loadable ``.pth``
    (epoch / model_state_dict / best_dice / config, the reference trainer's
    schema without its optimizer state), the weights loaded strictly into
    the model of ``arch`` on the way: the inverse of
    ``convert_torch_checkpoint``."""
    from unet_implementations_tpu_torch.training.checkpoint import read_meta, restore_params

    model = restore_params(checkpoint_path, _model_for_arch(arch, device="cpu"))
    meta = read_meta(checkpoint_path)
    sd = {k: v.detach().to("cpu", torch.float32).contiguous()
          for k, v in model.state_dict().items()}
    torch.save({"epoch": int(meta.get("epoch", 0)), "model_state_dict": sd,
                "best_dice": float(meta.get("best_metric", 0.0)),
                "config": {"exported_from": str(checkpoint_path), "arch": arch}},
               str(output_path))
