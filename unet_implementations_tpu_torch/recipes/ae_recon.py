"""AE_pretrained phase 1: autoencoder reconstruction pretraining.

Counterpart of ``unet_implementations_tpu/recipes/ae_recon.py``:
``autoencoder_6stage`` (``unet_6stage``'s topology with the sigmoid 3x3 head
and the lowered dropout), Adam(1e-3, L2 weight decay 1e-5) with a cosine LR
(T_max = epochs, eta_min = 1e-6), [0, 1] images with target == input, early
stopping on the minimum validation loss, checkpoints every ``save_every``
epochs and on a new best, and a test evaluation writing
``reconstruction_metrics.json`` (per-image MSE, PSNR, SSIM).

The trained objective defaults to plain MSE, the reference's trained truth
(its loss flags are parsed and ignored); nonzero ``perceptual_weight`` (a VGG16
on random weights, ``models/vgg.py``) or ``ssim_weight`` turn on the combined
loss. Its phase-2 counterpart, ``recipes/ae_transfer.py``, grafts this
model's encoder from ``best_model``.

Entry points run on CUDA unless ``device`` names another device. Gradient
accumulation and data parallelism work as in ``recipes/our_unet.py``; the
MSE (like every reconstruction term) is a mean over equal local batches, so
the ranks' averaged gradient is the global batch's with no reduction in the
loss. Not ported (it raises ``NotImplementedError``): the latent space
analysis. The reconstruction snapshots and comparison grids (matplotlib)
are not drawn; ``checkpoint_callback`` is the hook where they would go.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, Optional

import torch
from torch import nn

from unet_implementations_tpu_torch import default_device
from unet_implementations_tpu_torch.data.loader import PetDataset, batch_iterator
from unet_implementations_tpu_torch.models.unet import UNet, autoencoder_6stage
from unet_implementations_tpu_torch.ops.losses import FeatureFns, reconstruction_loss
from unet_implementations_tpu_torch.ops.normalize import normalize_image
from unet_implementations_tpu_torch.parallel.mesh import create_mesh, stripe, wrap
from unet_implementations_tpu_torch.recipes.common import check_grad_accum, evaluate_reconstruction
from unet_implementations_tpu_torch.recipes.our_unet import not_ported
from unet_implementations_tpu_torch.training.checkpoint import restore_checkpoint, restore_params
from unet_implementations_tpu_torch.training.loop import train_loop, write_training_config
from unet_implementations_tpu_torch.training.steps import (
    make_accum_train_step,
    make_reconstruction_eval_step,
    make_reconstruction_loss_fn,
    make_reconstruction_train_step,
    to_device,
)
from unet_implementations_tpu_torch.training.train_state import adam_l2, cosine_lr

ARCH_CONFIG = {
    "head": "reconstruction",
    "n_stages": 6,
    "features_per_stage": [32, 64, 128, 256, 512, 512],
    "encoder_dropout_rates": [0.0, 0.0, 0.05, 0.1, 0.15, 0.15],
    "decoder_dropout_rates": [0.15, 0.1, 0.1, 0.05, 0.0],
}


def build_model(dtype: torch.dtype = torch.bfloat16, device=None, seed: int = 0) -> UNet:
    return autoencoder_6stage(dtype=dtype, device=device,
                              generator=torch.Generator().manual_seed(seed))


def make_datasets(data_dir: str | Path, emit_uint8: bool = True, process_index: int = 0,
                  process_count: int = 1):
    """Train and validation datasets in reconstruction mode (no masks).
    ``emit_uint8`` leaves the pixels uint8; the steps scale them to [0, 1]
    on the device. The training set is the ``process_index``-th of
    ``process_count`` stripes; validation is not striped."""
    data_dir = Path(data_dir)
    train = PetDataset(data_dir / "Train" / "resized", None, include_augmented=True,
                       mode="reconstruction", emit_uint8=emit_uint8,
                       process_index=process_index, process_count=process_count)
    val = PetDataset(data_dir / "Val" / "resized", None, include_augmented=False,
                     mode="reconstruction", emit_uint8=emit_uint8)
    return train, val


def make_loss_fn(mse_weight: float = 1.0, perceptual_weight: float = 0.0,
                 ssim_weight: float = 0.0, feature_fns: Optional[FeatureFns] = None
                 ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """``loss_fn(recon, target) -> loss``, the composite AE objective.
    ``feature_fns`` (``models/vgg.py::make_features_fn``) is required for a
    nonzero ``perceptual_weight``; ``train`` builds it."""
    if perceptual_weight > 0 and feature_fns is None:
        raise ValueError("perceptual_weight > 0 requires feature_fns "
                         "(models/vgg.py::make_features_fn)")

    def loss_fn(recon: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return reconstruction_loss(recon, target, mse_weight=mse_weight,
                                   perceptual_weight=perceptual_weight, ssim_weight=ssim_weight,
                                   feature_fns=feature_fns)

    return loss_fn


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer, mse_weight: float = 1.0,
                    perceptual_weight: float = 0.0, ssim_weight: float = 0.0,
                    feature_fns: Optional[FeatureFns] = None) -> Callable:
    """``make_reconstruction_train_step`` on the composite loss."""
    return make_reconstruction_train_step(
        model, optimizer, make_loss_fn(mse_weight, perceptual_weight, ssim_weight, feature_fns))


def train(
    data_dir: str | Path,
    output_dir: str | Path,
    *,
    batch_size: int = 32,
    epochs: int = 100,
    lr: float = 1e-3,
    weight_decay: float = 1e-5,
    mse_weight: float = 1.0,
    perceptual_weight: float = 0.0,
    ssim_weight: float = 0.0,
    patience: int = 15,
    save_every: int = 10,
    resume: Optional[str] = None,
    seed: int = 0,
    dtype: torch.dtype = torch.bfloat16,
    device=None,
    num_threads: int = 8,
    grad_accum: int = 1,
    use_mesh: bool = True,
    checkpoint_callback: Optional[Callable[[nn.Module, int], None]] = None,
    verbose: bool = True,
) -> Dict:
    """Train the autoencoder from scratch (or from ``resume``, a checkpoint
    directory) and return the loop's result. ``checkpoint_callback(model,
    epoch)`` runs after each checkpoint is written (by rank 0 alone under
    data parallelism)."""
    check_grad_accum(batch_size, grad_accum, use_mesh=use_mesh)
    device = default_device(device)
    mesh = create_mesh(device) if use_mesh else None
    output_dir = Path(output_dir)
    write_training_config(output_dir, dict(
        data_dir=str(data_dir), output_dir=str(output_dir), batch_size=batch_size,
        epochs=epochs, lr=lr, weight_decay=weight_decay, mse_weight=mse_weight,
        perceptual_weight=perceptual_weight, ssim_weight=ssim_weight, patience=patience,
        save_every=save_every, seed=seed, dtype=str(dtype), grad_accum=grad_accum,
    ))

    train_ds, val_ds = make_datasets(data_dir, **stripe(mesh))
    if verbose:
        print(f"Training dataset size: {len(train_ds)}")
        print(f"Validation dataset size: {len(val_ds)}")

    model = build_model(dtype, device, seed)
    optimizer = adam_l2(model.parameters(), lr, weight_decay)
    feature_fns = None
    if perceptual_weight > 0:
        from unet_implementations_tpu_torch.models.vgg import make_features_fn

        # Random weights, as the reference's VGG16(weights=None).
        feature_fns = make_features_fn(torch.Generator().manual_seed(seed + 2), dtype=dtype,
                                       device=device)
    start_epoch, best, es_state, step = 0, None, None, 0
    if resume:
        meta = restore_checkpoint(resume, model, optimizer)
        start_epoch = meta.get("epoch", 0)
        best = meta.get("best_metric")
        es_state = meta.get("early_stopping")
        step = meta["step"]
        if verbose:
            print(f"Resumed from epoch {start_epoch}")

    trained = wrap(model) if mesh is not None else model
    train_step = make_accum_train_step(
        trained, optimizer, make_reconstruction_loss_fn(
            make_loss_fn(mse_weight, perceptual_weight, ssim_weight, feature_fns)), grad_accum)
    eval_step = make_reconstruction_eval_step(model)
    local_batch = mesh.local_batch(batch_size) if mesh is not None else batch_size

    def train_batches(epoch):
        return batch_iterator(train_ds, local_batch, shuffle=True, seed=seed * 1000 + epoch,
                              drop_last=True, num_threads=num_threads)

    def val_batches():
        return batch_iterator(val_ds, batch_size, num_threads=num_threads)

    return train_loop(
        trained, optimizer,
        train_step=train_step,
        eval_step=eval_step,
        train_batches=train_batches,
        val_batches=val_batches,
        lr_schedule=cosine_lr(lr, epochs),
        epochs=epochs,
        output_dir=output_dir,
        task="reconstruction",
        dropout_seed=seed + 1,
        step=step,
        save_every=save_every,
        patience=patience,
        start_epoch=start_epoch,
        best_metric=best,
        early_stopping_state=es_state,
        arch_config=ARCH_CONFIG,
        checkpoint_callback=checkpoint_callback,
        mesh=mesh,
        verbose=verbose,
    )


def evaluate(
    model_path: str | Path,
    data_dir: str | Path,
    output_dir: str | Path,
    *,
    batch_size: int = 32,
    dtype: torch.dtype = torch.bfloat16,
    device=None,
    analyze_latent_space: bool = False,
    visualize_samples: int = 0,
    num_threads: int = 8,
    verbose: bool = True,
) -> Dict:
    """Evaluate a checkpoint directory, or a reference ``.pth`` of the
    autoencoder, on ``Test/resized``: per-image MSE, PSNR and SSIM, written
    as ``reconstruction_metrics.json``."""
    if analyze_latent_space:
        raise not_ported("--analyze_latent_space", 8)
    if visualize_samples > 0:
        raise not_ported("--visualize_samples", 8)
    device = default_device(device)
    model = restore_params(model_path, build_model(dtype, device)).eval()

    # uint8 pixels cross to the device and are scaled there: the same float32
    # values as the host's /255, a quarter of the bytes.
    test_ds = PetDataset(Path(data_dir) / "Test" / "resized", None, include_augmented=False,
                         mode="reconstruction", emit_uint8=True)
    if verbose:
        print(f"Test dataset size: {len(test_ds)} images")

    @torch.inference_mode()
    def recon_fn(batch):
        images = normalize_image(to_device(batch["image"], device), mode="unit")
        return model(images.to(dtype))

    return evaluate_reconstruction(recon_fn, test_ds, batch_size, output_dir,
                                   num_threads=num_threads, verbose=verbose)
