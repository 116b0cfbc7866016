"""The segmentation and reconstruction train and eval steps.

Counterpart of ``unet_implementations_tpu/training/steps.py`` (its lines
29-261). JAX jits a pure ``(state, batch, rng) -> (state, loss)``; the port
runs eagerly and updates the model and its optimizer in place.

A batch is ``{"image": (B, H, W, 3) uint8 or float, "mask": (B, H, W) int}``,
numpy arrays or tensors, and with ``use_clip`` also ``"clip_features"``
(B, clip_dim), the CLIP embeddings the model fuses at its bottleneck
(``recipes/clip_unet.py`` attaches them). It moves to the model's device
(through pinned memory, ``to_device``), where uint8 pixels are
ImageNet-normalized in the step (``ops.normalize``), as in JAX.

The objective is a ``loss_fn(model, batch, generator) -> loss``
(``make_segmentation_loss_fn``, ``make_reconstruction_loss_fn``), shared by
the plain step and the gradient-accumulation step, so the two cannot
diverge. The train step runs the forward in training mode, with channel
dropout drawn from the ``torch.Generator`` it is given (on the model's
device), the loss (with per-batch class weights), ``backward()`` and
``optimizer.step()``: the forward launches K1 and K2, the backward K1's
backward kernel (K1bwd); only K2's transpose runs in plain torch. The eval
step runs in eval mode under ``torch.inference_mode`` (so in the s2d layout
the fused block tail, K3, runs) and returns the loss, the per-class batch
Dice, the argmax predictions and a confusion matrix.

Under data parallelism the train steps take a ``DistributedDataParallel``
model (``parallel/mesh.py``): the segmentation loss then reduces its class
counts and CE denominator over the model's process group, so the averaged
gradient is the global batch's, and the loss a step returns is the global
one (the mean over the ranks of their shares, one all-reduce).

Under spatial partitioning the train steps take a ``SpatialParallel`` model
(``parallel/spatial.py``): the loss function keeps this rank's rows of the
batch's images and masks, the loss sums Dice's per-image sums over the space
group and the class counts over the grid, and the plain step all-reduces the
gradients over the grid after the backward (``average_gradients``), so the
update is the global batch's. The step's dropout generator must be the same
on every rank of a space group (``training/loop.py`` seeds it from the data
rank). Gradient accumulation under it is refused, as in JAX.

The reconstruction steps take ``{"image", "target"}`` (uint8, or float in
[0, 1]), scale uint8 to [0, 1] on the device (``mode="unit"``, no ImageNet
statistics), and train on the MSE, or on ``objective(recon, target)`` (the
composite loss of ``recipes/ae_recon.py``).
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from unet_implementations_tpu_torch.ops.losses import mse_loss, psnr, segmentation_loss
from unet_implementations_tpu_torch.ops.metrics import batch_dice_scores, confusion_matrix
from unet_implementations_tpu_torch.ops.normalize import normalize_image
from unet_implementations_tpu_torch.parallel.mesh import process_group
from unet_implementations_tpu_torch.parallel.spatial import grid_of, shard_rows

# ``loss_fn(model, batch, generator) -> loss``: the objective of one batch.
LossFn = Callable[[nn.Module, Dict, Optional[torch.Generator]], torch.Tensor]
# The batch keys a microbatch splits; the others (file names, indices) stay
# behind.
MICROBATCH_KEYS = ("image", "mask", "target", "clip_features")


def to_device(value, device: torch.device) -> torch.Tensor:
    """A host array (or a tensor) on ``device``. From the host to a CUDA
    device it goes through page-locked memory: a copy from pageable memory
    holds the stream for the whole staged transfer, so the device would wait
    for it on every batch; from pinned memory the copy runs at the link's
    rate and the host does not wait."""
    tensor = torch.as_tensor(value)
    if device.type == "cuda" and tensor.device.type == "cpu":
        tensor = tensor.pin_memory()
    return tensor.to(device, non_blocking=True)


def _device_of(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _on_device(batch: Dict, device: torch.device):
    return normalize_image(to_device(batch["image"], device)), to_device(batch["mask"], device)


def _clip_kwargs(batch: Dict, device: torch.device, use_clip: bool) -> Dict:
    """The model's ``clip_features`` keyword: the batch's features on the
    device with ``use_clip`` (None when the batch has none, as JAX's
    ``batch.get``), else nothing."""
    if not use_clip:
        return {}
    features = batch.get("clip_features")
    return {"clip_features": None if features is None else to_device(features, device)}


def make_segmentation_loss_fn(
    *,
    weight_ce: float = 1.0,
    weight_dice: float = 1.0,
    dynamic_weights: bool = True,
    static_weights: Optional[torch.Tensor] = None,
    use_clip: bool = False,
) -> LossFn:
    """``loss_fn(model, batch, generator) -> loss``: a training forward of
    ``batch`` and its Dice + weighted-CE loss (JAX's
    ``make_segmentation_loss_fn``). ``static_weights`` (C,) replaces the
    per-batch class weights; ``use_clip`` feeds the batch's
    ``clip_features`` to the model. A ``DistributedDataParallel`` model's
    process group makes it the rank's share of the global loss
    (``ops/losses.py``); so does a ``SpatialParallel`` model's grid, on this
    rank's rows of the batch."""

    def loss_fn(model: nn.Module, batch: Dict, generator: Optional[torch.Generator]):
        device = _device_of(model)
        group = process_group(model)
        grid = grid_of(model)
        if grid is not None:  # this rank's rows, before they cross to the device
            batch = shard_rows(batch, grid.context)
        image, mask = _on_device(batch, device)
        clip = _clip_kwargs(batch, device, use_clip)
        if group is not None and use_clip and clip["clip_features"] is None:
            # Without features the fusion's parameters take no gradient,
            # which DistributedDataParallel's reducer refuses.
            raise ValueError("a CLIP model trains data-parallel only with clip_features")
        logits = model(image, generator=generator, **clip)
        return segmentation_loss(logits, mask, weight_ce=weight_ce, weight_dice=weight_dice,
                                 class_weights=static_weights,
                                 dynamic_weights=dynamic_weights and static_weights is None,
                                 group=group,
                                 space_group=grid.context.group if grid is not None else None)

    return loss_fn


def _recon_on_device(batch: Dict, device: torch.device):
    return (normalize_image(to_device(batch["image"], device), mode="unit"),
            normalize_image(to_device(batch["target"], device), mode="unit"))


def make_reconstruction_loss_fn(
    objective: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = mse_loss,
) -> LossFn:
    """``loss_fn(model, batch, generator) -> loss``: a training forward of
    ``batch["image"]`` and ``objective(recon, target)`` (plain MSE by
    default, the reference's trained objective; JAX's
    ``recipes/ae_recon.py::make_loss_fn``). The objective is a mean over the
    batch, so under data parallelism with equal local batches the average of
    the ranks' gradients is already the global batch's: no reduction."""

    def loss_fn(model: nn.Module, batch: Dict, generator: Optional[torch.Generator]):
        image, target = _recon_on_device(batch, _device_of(model))
        return objective(model(image, generator=generator), target)

    return loss_fn


def _global(loss: torch.Tensor, model: nn.Module) -> torch.Tensor:
    """The value a step reports: ``loss`` itself, or under data parallelism
    the mean of the ranks' values (the global batch's loss)."""
    group = process_group(model)
    if group is None:
        return loss
    total = loss.clone()
    dist.all_reduce(total, group=group)
    return total / dist.get_world_size(group)


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    loss_fn: LossFn) -> Callable:
    """``step(batch, generator) -> loss`` (a detached float32 scalar on the
    model's device): one forward of ``loss_fn``, backward and optimizer
    update of ``model`` in place (a ``SpatialParallel`` model's gradients
    averaged over its grid first)."""
    grid = grid_of(model)

    def step(batch: Dict, generator: Optional[torch.Generator]) -> torch.Tensor:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch, generator)
        loss.backward()
        if grid is not None:
            model.average_gradients()
        optimizer.step()
        return _global(loss.detach(), model)

    return step


def microbatch_generator(generator: Optional[torch.Generator],
                         i: int) -> Optional[torch.Generator]:
    """The dropout generator of microbatch ``i``, on ``generator``'s device:
    seeded from ``(generator's seed, i)`` mixed by numpy's ``SeedSequence``
    (JAX's ``fold_in(rng, i)``). The step's generator is seeded from
    ``(dropout seed, step)`` (``training/loop.py::dropout_generator``), so a
    resume draws the same masks."""
    if generator is None:
        return None
    seed = generator.initial_seed()
    mixed = np.random.SeedSequence([seed & 0xFFFFFFFF, seed >> 32, i & 0xFFFFFFFF])
    return torch.Generator(device=generator.device).manual_seed(
        int(mixed.generate_state(1, np.uint64)[0]))


def make_accum_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                          loss_fn: LossFn, accum: int) -> Callable:
    """Gradient accumulation (JAX's ``make_accum_train_step``): ``step(batch,
    generator) -> loss``, one optimizer update from ``accum`` sequential
    microbatches.

    Microbatch i is the strided rows ``batch[i::accum]`` of every key in
    ``MICROBATCH_KEYS`` (under data parallelism the global microbatch i is
    then the union of the ranks' ``local[i::accum]``), with the dropout
    generator ``microbatch_generator(generator, i)``. The gradients of
    ``loss / accum`` add up in the float32 ``.grad`` of the parameters, one
    ``optimizer.step()`` follows, and the step returns the mean of the
    microbatch losses, detached. The objective is each microbatch's own
    (its class weights, CE normalization, batch-mean Dice), so this is not
    the full-batch step; only one microbatch's activations are alive at a
    time. A wrapped model skips its gradient all-reduce (``no_sync``) on
    every microbatch but the last. A batch that ``accum`` does not divide
    raises; ``accum == 1`` is the plain step."""
    if accum < 1:
        raise ValueError(f"accum must be >= 1, got {accum}")
    if accum == 1:
        return make_train_step(model, optimizer, loss_fn)
    if grid_of(model) is not None:
        raise ValueError("gradient accumulation with spatial partitioning is not supported: "
                         "spatial partitioning already divides the activation footprint")

    def step(batch: Dict, generator: Optional[torch.Generator]) -> torch.Tensor:
        b = len(batch["image"])
        if b % accum:
            raise ValueError(f"gradient accumulation: batch size {b} does not divide into "
                             f"accum={accum} equal microbatches")
        device = _device_of(model)
        rows = {k: to_device(batch[k], device) for k in MICROBATCH_KEYS
                if batch.get(k) is not None}
        model.train()
        optimizer.zero_grad(set_to_none=True)
        total = torch.zeros((), dtype=torch.float32, device=device)
        for i in range(accum):
            micro = {k: v[i::accum].contiguous() for k, v in rows.items()}
            last = i == accum - 1
            with nullcontext() if last or process_group(model) is None else model.no_sync():
                loss = loss_fn(model, micro, microbatch_generator(generator, i))
                (loss / accum).backward()
            total += loss.detach()
        optimizer.step()
        return _global(total / accum, model)

    return step


def make_segmentation_train_step(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    *,
    weight_ce: float = 1.0,
    weight_dice: float = 1.0,
    dynamic_weights: bool = True,
    static_weights: Optional[torch.Tensor] = None,
    use_clip: bool = False,
) -> Callable:
    """``step(batch, generator) -> loss`` (a float32 scalar tensor on the
    model's device, detached): one forward, backward and optimizer update of
    ``model`` in place, on ``make_segmentation_loss_fn``'s objective."""
    return make_train_step(model, optimizer, make_segmentation_loss_fn(
        weight_ce=weight_ce, weight_dice=weight_dice, dynamic_weights=dynamic_weights,
        static_weights=static_weights, use_clip=use_clip))


def make_segmentation_eval_step(
    model: nn.Module,
    *,
    weight_ce: float = 1.0,
    weight_dice: float = 1.0,
    dynamic_weights: bool = True,
    static_weights: Optional[torch.Tensor] = None,
    use_clip: bool = False,
) -> Callable:
    """``step(batch) -> {"loss", "dice" (3,), "preds" (B, H, W) int32,
    "confusion" (3, 3)}``, all on the model's device; ``use_clip`` as in the
    train step."""
    device = next(model.parameters()).device

    @torch.inference_mode()
    def step(batch: Dict) -> Dict[str, torch.Tensor]:
        model.eval()
        image, mask = _on_device(batch, device)
        logits = model(image, **_clip_kwargs(batch, device, use_clip))
        loss = segmentation_loss(logits, mask, weight_ce=weight_ce, weight_dice=weight_dice,
                                 class_weights=static_weights,
                                 dynamic_weights=dynamic_weights and static_weights is None)
        preds = torch.argmax(logits, dim=-1).to(torch.int32)
        return {"loss": loss, "dice": batch_dice_scores(preds, mask), "preds": preds,
                "confusion": confusion_matrix(preds, mask)}

    return step


def make_reconstruction_train_step(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    objective: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = mse_loss,
) -> Callable:
    """``step(batch, generator) -> loss`` (a detached float32 scalar on the
    model's device): a training forward with channel dropout from
    ``generator``, ``objective(recon, target)`` (plain MSE by default, the
    reference's trained objective), backward and optimizer update in
    place."""
    return make_train_step(model, optimizer, make_reconstruction_loss_fn(objective))


def make_reconstruction_eval_step(model: nn.Module) -> Callable:
    """``step(batch) -> {"loss" (the MSE), "mse" (B,), "psnr" (B,), "recon"
    (B, H, W, 3) float32}``, all on the model's device."""
    device = next(model.parameters()).device

    @torch.inference_mode()
    def step(batch: Dict) -> Dict[str, torch.Tensor]:
        model.eval()
        image, target = _recon_on_device(batch, device)
        recon = model(image)
        diff = recon.to(torch.float32) - target.to(torch.float32)
        return {"loss": mse_loss(recon, target), "mse": torch.mean(diff * diff, dim=(1, 2, 3)),
                "psnr": psnr(recon, target), "recon": recon}

    return step
