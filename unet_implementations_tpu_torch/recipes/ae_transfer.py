"""AE_pretrained phase 2: segmentation with a frozen AE-pretrained encoder.

Counterpart of ``unet_implementations_tpu/recipes/ae_transfer.py``: the
6-stage segmentation UNet whose six encoder stages (the bottleneck included)
are copied from a phase-1 autoencoder checkpoint (``recipes/ae_recon.py``'s
``best_model``; the topology is the same) and frozen. JAX maps the frozen
sub-trees to ``optax.set_to_zero``; here they take ``requires_grad_(False)``
and only the trainable parameters go to the optimizer, so the frozen stages
get neither updates nor weight decay. With the input taking no gradient
either, autograd records nothing in the encoder: its backward (its convs'
gradients and its 12 InstanceNorm backwards) never runs.

Everything else is the ``our_unet`` recipe: SGD-Nesterov, poly LR, Dice +
weighted CE, early stopping on mean foreground Dice, online augmentation,
gradient accumulation (the frozen encoder takes no gradient in any
microbatch), data parallelism, and its evaluation.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import torch

from unet_implementations_tpu_torch import default_device
from unet_implementations_tpu_torch.models.unet import encoder_param_names
from unet_implementations_tpu_torch.parallel.mesh import create_mesh, stripe
from unet_implementations_tpu_torch.recipes import our_unet
from unet_implementations_tpu_torch.recipes.common import check_grad_accum
from unet_implementations_tpu_torch.recipes.our_unet import (
    build_model,
    make_datasets,
    online_augmenter,
)
from unet_implementations_tpu_torch.training.checkpoint import extract_encoder_params
from unet_implementations_tpu_torch.training.loop import write_training_config
from unet_implementations_tpu_torch.training.train_state import sgd_nesterov, with_frozen

ARCH_CONFIG = dict(our_unet.ARCH_CONFIG, pretrained_encoder=True, frozen_encoder=True)

# Evaluation is the plain recipe's (same architecture).
evaluate = our_unet.evaluate


def train(
    data_dir: str | Path,
    output_dir: str | Path,
    *,
    pretrained_encoder: str | Path,
    batch_size: int = 32,
    epochs: int = 100,
    lr: float = 5e-3,
    weight_decay: float = 1e-4,
    momentum: float = 0.99,
    weighted_ce: bool = True,
    static_weights: bool = False,
    dice_weight: float = 1.0,
    ce_weight: float = 1.0,
    patience: int = 15,
    save_every: int = 10,
    resume: Optional[str] = None,
    seed: int = 0,
    dtype: torch.dtype = torch.bfloat16,
    device=None,
    num_threads: int = 8,
    online_augment: bool = False,
    grad_accum: int = 1,
    use_mesh: bool = True,
    verbose: bool = True,
) -> Dict:
    """Train the segmentation decoders on the frozen encoder of
    ``pretrained_encoder`` (an ``ae_recon`` checkpoint directory or its
    ``.pth``) and return the loop's result."""
    check_grad_accum(batch_size, grad_accum, use_mesh=use_mesh)
    device = default_device(device)
    mesh = create_mesh(device) if use_mesh else None
    output_dir = Path(output_dir)
    write_training_config(output_dir, dict(
        data_dir=str(data_dir), output_dir=str(output_dir),
        pretrained_encoder=str(pretrained_encoder), batch_size=batch_size, epochs=epochs, lr=lr,
        weight_decay=weight_decay, momentum=momentum, weighted_ce=weighted_ce,
        static_weights=static_weights, dice_weight=dice_weight, ce_weight=ce_weight,
        patience=patience, save_every=save_every, seed=seed, dtype=str(dtype),
        grad_accum=grad_accum,
    ))

    train_ds, val_ds = make_datasets(data_dir, include_augmented=not online_augment,
                                     **stripe(mesh))
    if verbose:
        print(f"Training dataset size: {len(train_ds)}")
        print(f"Validation dataset size: {len(val_ds)}")

    model = build_model(dtype, device, seed)
    extract_encoder_params(pretrained_encoder, model, n_stages=model.n_stages)
    with_frozen(model, encoder_param_names(model.n_stages))
    if verbose:
        print(f"Loaded pretrained encoder from {pretrained_encoder}; frozen.")
    optimizer = sgd_nesterov([p for p in model.parameters() if p.requires_grad], lr,
                             weight_decay, momentum)
    return our_unet.fit(model, optimizer, train_ds, val_ds, output_dir, batch_size=batch_size,
                        epochs=epochs, lr=lr, weighted_ce=weighted_ce,
                        static_weights=static_weights, dice_weight=dice_weight,
                        ce_weight=ce_weight, patience=patience, save_every=save_every,
                        resume=resume, seed=seed, num_threads=num_threads,
                        arch_config=ARCH_CONFIG, verbose=verbose, grad_accum=grad_accum,
                        mesh=mesh,
                        augment=online_augmenter(seed, device, mesh) if online_augment else None)
