"""Grad-CAM of a UNet layer for one class.

Counterpart of ``unet_implementations_tpu/utils/gradcam.py``. The target is
a module path. The default names the reference's target, the first conv of
the first decoder, ``decoder_stages.0.conv_block.block.0`` (JAX:
``("decoder_0", "conv_block", "conv_0")``). The port applies its convs
through ``models/blocks.py::conv2d``, so that ``nn.Conv2d`` is never called
and a hook on it would never fire; its output is the input of the
``InstanceNorm`` that follows it in the block's Sequential, so a forward
pre-hook on that norm captures it. Any other target is a module the forward
calls (e.g. ``decoder_stages.0.conv_block``, JAX's ``("decoder_0",
"conv_block")``), captured by a forward hook on its output. The hook hands
the rest of the forward a detached copy that requires grad, and the gradient
of the class score (the sum of the class's float32 logits) with respect to
it is taken; the backward runs from the logits down to the target only.
CAM = ReLU(Σ_c mean_hw(∂score/∂A_c) · A_c), min-max normalized and resized
bilinearly to the input's size (``ops/resize.py``), as JAX's.

A conv's output goes into an InstanceNorm, which is invariant to adding a
constant to a channel, so the spatial mean of the gradient there is zero:
at the default target (JAX's and the reference's) the weights are the
rounding noise of a zero sum, in JAX as here, and the CAM is that noise's
pattern. A target after a norm (a block's output) gives a CAM that does not
depend on roundings.

On a card the forward runs K1 and K2a and the backward K1bwd and K2a's
transpose, like a train step's backward over the decoders.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
from torch import nn

from unet_implementations_tpu_torch.models.blocks import InstanceNorm, nhwc
from unet_implementations_tpu_torch.ops.resize import resize_bilinear

# First conv of the first decoder stage: the reference's default target.
DEFAULT_TARGET = "decoder_stages.0.conv_block.block.0"


def _hook(model: nn.Module, target: str, capture) -> torch.utils.hooks.RemovableHandle:
    """Register ``capture`` for the activation at ``target``: a pre-hook on
    the InstanceNorm after a block conv, else a forward hook on the module."""
    parent, _, index = target.rpartition(".")
    try:
        module = model.get_submodule(target)
    except AttributeError as e:
        raise ValueError(f"target module path {target!r} not found: {e}") from e
    if not isinstance(module, nn.Conv2d):
        return module.register_forward_hook(lambda m, args, out: capture(out))
    block = model.get_submodule(parent) if parent else None
    nxt = int(index) + 1 if index.isdigit() else None
    if not (isinstance(block, nn.Sequential) and nxt is not None and nxt < len(block)
            and isinstance(block[nxt], InstanceNorm)):
        raise ValueError(f"target {target!r} is a conv that no InstanceNorm follows in its "
                         "block; the forward never calls it")
    return block[nxt].register_forward_pre_hook(
        lambda m, args: (capture(args[0]), *args[1:]))


def gradcam(model: nn.Module, image, target_class: int,
            target: str = DEFAULT_TARGET) -> np.ndarray:
    """A (H, W) float32 CAM in [0, 1] of ``target_class`` for ``image``, a
    (1, H, W, 3) normalized image (a tensor or a numpy array), on the model's
    device in its dtype. The model runs in eval mode with grad enabled; its
    mode is restored, and the hook removed, after. A target that names no
    module, or one the forward does not reach, raises ``ValueError``."""
    device = next(model.parameters()).device
    x = torch.as_tensor(image if torch.is_tensor(image) else np.asarray(image), device=device)
    captured = []

    def capture(act: torch.Tensor) -> torch.Tensor:
        act = act.detach().requires_grad_(True)
        captured.append(act)
        return act

    was_training = model.training
    handle = _hook(model, target, capture)
    try:
        model.eval()
        with torch.enable_grad():
            logits = model(x)
            if not captured:
                raise ValueError(f"target {target!r} was not reached by the forward")
            score = logits[..., target_class].to(torch.float32).sum()
            grads, = torch.autograd.grad(score, captured[0])
    finally:
        handle.remove()
        model.train(was_training)
    act = nhwc(captured[0].detach()).to(torch.float32)                   # (1, h, w, C)
    weights = nhwc(grads).to(torch.float32).mean(dim=(1, 2))             # (1, C)
    cam = torch.clamp((act * weights[:, None, None, :]).sum(dim=-1), min=0.0)[0]
    cam = cam - cam.min()
    cam = cam / torch.clamp(cam.max(), min=1e-8)
    cam = resize_bilinear(cam[None, :, :, None], tuple(x.shape[1:3]))
    return cam[0, :, :, 0].cpu().numpy().astype(np.float32)


def visualize_gradcam(model: nn.Module, image, target_class: int, save_path: str | Path,
                      target: str = DEFAULT_TARGET) -> np.ndarray:
    """Draw the image, the CAM and their jet overlay (matplotlib); returns
    the CAM."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.cm as cm
    import matplotlib.pyplot as plt

    from unet_implementations_tpu_torch.utils.visualize import denormalize_image

    cam = gradcam(model, image, target_class, target)
    pixels = image.float().cpu().numpy() if torch.is_tensor(image) else np.asarray(image)
    base = denormalize_image(pixels[0]).astype(np.float32) / 255.0
    heat = cm.jet(cam)[..., :3]
    blend = np.clip(0.5 * base + 0.5 * heat, 0, 1)
    fig, axes = plt.subplots(1, 3, figsize=(14, 5))
    for ax, img, title in [(axes[0], base, "Image"), (axes[1], cam, "Grad-CAM"),
                           (axes[2], blend, "Overlay")]:
        ax.imshow(img, cmap="jet" if title == "Grad-CAM" else None)
        ax.set_title(title)
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(save_path, dpi=100)
    plt.close(fig)
    return cam
