"""Our_UNet recipe: the 6-stage UNet trained from scratch on Pet segmentation.

Counterpart of ``unet_implementations_tpu/recipes/our_unet.py``:
SGD(5e-3, weight decay 1e-4, momentum 0.99, Nesterov) with polynomial LR
decay, the combined Dice + weighted-CE loss with dynamic / static /
unweighted class weights, early stopping (patience 15) on mean foreground
Dice, checkpoints every 10 epochs and on a new best, and the
original-resolution test evaluation writing ``evaluation_results.json``.

The model is ``unet_6stage`` in the port's default (dense) layout, with
float32 parameters and bf16 compute unless ``dtype`` says otherwise. Entry
points run on CUDA unless ``device`` names another device. With
``online_augment`` each training batch is augmented on that device
(``recipes/common.py::wrap_online_augment``) and ``Train/augmented/`` is not
read. ``grad_accum`` > 1 splits each batch into that many sequential
microbatches, one optimizer update per batch
(``training/steps.py::make_accum_train_step``). Under a process group of
several ranks (``parallel/``) training is data-parallel unless
``use_mesh=False``: each rank trains on its stripe of the training files,
``batch_size`` stays the global batch, and the loss is the global batch's.
``spatial`` > 1 shards each image's rows over that many ranks of the process
group (a (data, space) grid, ``parallel/spatial.py``): the ranks of a space
group read the same stripe, each trains on its rows of the images, and the
update is the global batch's. It needs the mesh (not ``use_mesh=False``) and
refuses ``grad_accum`` > 1, as JAX does; validation runs unsharded on every
rank. Not ported yet (raises ``NotImplementedError``): the evaluation's
visualizations.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from unet_implementations_tpu_torch import default_device
from unet_implementations_tpu_torch.data.loader import PetDataset, batch_iterator
from unet_implementations_tpu_torch.models.unet import UNet, unet_6stage
from unet_implementations_tpu_torch.parallel.mesh import DataParallel, create_mesh, stripe, wrap
from unet_implementations_tpu_torch.parallel.spatial import (
    SpatialGrid,
    SpatialParallel,
    create_mesh_dp_sp,
)
from unet_implementations_tpu_torch.recipes.common import (
    check_grad_accum,
    evaluate_segmentation,
    not_ported,
    wrap_online_augment,
)
from unet_implementations_tpu_torch.training.checkpoint import restore_checkpoint, restore_params
from unet_implementations_tpu_torch.training.loop import train_loop, write_training_config
from unet_implementations_tpu_torch.training.steps import (
    make_accum_train_step,
    make_segmentation_eval_step,
    make_segmentation_loss_fn,
    to_device,
)
from unet_implementations_tpu_torch.training.train_state import poly_lr, sgd_nesterov

ARCH_CONFIG = {
    "num_classes": 3,
    "n_stages": 6,
    "features_per_stage": [32, 64, 128, 256, 512, 512],
    "strides": [1, 2, 2, 2, 2, 2],
    "encoder_dropout_rates": [0.0, 0.0, 0.1, 0.2, 0.3, 0.3],
    "decoder_dropout_rates": [0.3, 0.2, 0.2, 0.1, 0.0],
}


def build_model(dtype: torch.dtype = torch.bfloat16, device=None, seed: int = 0) -> UNet:
    return unet_6stage(dtype=dtype, device=device,
                       generator=torch.Generator().manual_seed(seed))


def compute_static_weights(dataset: PetDataset, batch_size: int = 32) -> np.ndarray:
    """Dataset-wide inverse-frequency class weights, summing to 3. With
    several processes they are counted over the full file list, so every
    process trains on the same loss."""
    if dataset.process_count > 1:
        dataset = PetDataset(
            dataset.images_dir, dataset.masks_dir,
            include_augmented=dataset.aug_masks_dir is not None,
            target_size=dataset.target_size, normalize=dataset.normalize,
            emit_uint8=True,
        )
    counts = np.zeros(3, np.float64)
    total = 0.0
    for batch in batch_iterator(dataset, batch_size, shuffle=False):
        mask = batch["mask"]
        valid = mask != 255
        for c in range(3):
            counts[c] += ((mask == c) & valid).sum()
        total += valid.sum()
    counts = np.maximum(counts, 1.0)
    weights = total / counts
    return (weights * (3 / weights.sum())).astype(np.float32)


def make_datasets(
    data_dir: str | Path,
    include_augmented: bool = True,
    normalize_train: bool = True,
    emit_uint8: bool = True,
    process_index: int = 0,
    process_count: int = 1,
):
    """Train and validation datasets for the training loop. ``emit_uint8``
    (on for training) leaves the pixels uint8; the steps normalize them on
    the device. The training set is the ``process_index``-th of
    ``process_count`` stripes of the files; validation is not striped."""
    data_dir = Path(data_dir)
    train = PetDataset(
        data_dir / "Train" / "resized",
        data_dir / "Train" / "resized_label",
        include_augmented=include_augmented,
        normalize=normalize_train,
        emit_uint8=emit_uint8,
        process_index=process_index,
        process_count=process_count,
    )
    val = PetDataset(
        data_dir / "Val" / "resized",
        data_dir / "Val" / "processed_labels",
        include_augmented=False,
        emit_uint8=emit_uint8,
    )
    return train, val


def train(
    data_dir: str | Path,
    output_dir: str | Path,
    *,
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
    spatial: int = 0,
    grad_accum: int = 1,
    use_mesh: bool = True,
    verbose: bool = True,
) -> Dict:
    """Train from scratch (or from ``resume``, a checkpoint directory) and
    return the loop's result (``best_metric``, ``epochs_run``, ``step`` and
    each epoch's timers)."""
    n_space = max(spatial, 1)
    check_grad_accum(batch_size, grad_accum, use_mesh=use_mesh, spatial=n_space)
    if n_space > 1 and not use_mesh:
        raise ValueError("--spatial requires the device mesh; drop --no_mesh or --spatial "
                         "(they contradict).")
    if n_space > 1 and grad_accum > 1:
        raise ValueError("--grad_accum with --spatial is not supported: spatial partitioning "
                         "already divides the activation footprint; use one or the other.")
    device = default_device(device)
    if n_space > 1:
        mesh = create_mesh_dp_sp(n_space, device=device)
    else:
        mesh = create_mesh(device) if use_mesh else None
    output_dir = Path(output_dir)
    write_training_config(output_dir, dict(
        data_dir=str(data_dir), output_dir=str(output_dir), batch_size=batch_size,
        epochs=epochs, lr=lr, weight_decay=weight_decay, momentum=momentum,
        weighted_ce=weighted_ce, static_weights=static_weights,
        dice_weight=dice_weight, ce_weight=ce_weight, patience=patience,
        save_every=save_every, seed=seed, dtype=str(dtype),
        online_augment=online_augment, spatial=spatial, grad_accum=grad_accum,
    ))

    train_ds, val_ds = make_datasets(data_dir, include_augmented=not online_augment,
                                     **stripe(mesh))
    if verbose:
        print(f"Training dataset size: {len(train_ds)}")
        print(f"Validation dataset size: {len(val_ds)}")

    model = build_model(dtype, device, seed)
    optimizer = sgd_nesterov(model.parameters(), lr, weight_decay, momentum)
    return fit(model, optimizer, train_ds, val_ds, output_dir, batch_size=batch_size,
               epochs=epochs, lr=lr, weighted_ce=weighted_ce, static_weights=static_weights,
               dice_weight=dice_weight, ce_weight=ce_weight, patience=patience,
               save_every=save_every, resume=resume, seed=seed, num_threads=num_threads,
               arch_config=ARCH_CONFIG, verbose=verbose, grad_accum=grad_accum, mesh=mesh,
               augment=online_augmenter(seed, device, mesh) if online_augment else None)


def online_augmenter(seed: int, device, mesh: Optional[DataParallel] = None
                     ) -> Callable[[Iterable[Dict], int], Iterable[Dict]]:
    """``fit``'s ``augment`` hook for ``online_augment``: each epoch's
    training batches augmented on ``device`` (with the rank's own draws
    under ``mesh``)."""
    rank = mesh.data_rank if mesh is not None else 0
    return lambda batches, epoch: wrap_online_augment(batches, epoch, seed, device, rank=rank)


def fit(model: UNet, optimizer: torch.optim.Optimizer, train_ds: PetDataset,
        val_ds: PetDataset, output_dir: Path, *, batch_size: int, epochs: int, lr: float,
        weighted_ce: bool, static_weights: bool, dice_weight: float, ce_weight: float,
        patience: int, save_every: int, resume: Optional[str], seed: int, num_threads: int,
        arch_config: Dict, verbose: bool, grad_accum: int = 1,
        mesh: Optional[DataParallel] = None,
        features: Optional[Callable[[Iterable[Dict], str], Iterable[Dict]]] = None,
        augment: Optional[Callable[[Iterable[Dict], int], Iterable[Dict]]] = None) -> Dict:
    """The segmentation training of ``model`` by ``optimizer`` (shared with
    ``recipes/ae_transfer.py`` and ``recipes/clip_unet.py``): the loss's
    class weights, the train step (``grad_accum`` microbatches a batch) and
    the eval step, a resume, and ``train_loop`` with poly LR decay and early
    stopping on mean foreground Dice. Under ``mesh`` the model is wrapped
    for data parallelism after the resume (for spatial partitioning, on a
    ``SpatialGrid``), ``train_ds`` is this rank's stripe read in batches of
    ``batch_size / n_data``, and validation runs the whole of ``val_ds`` at
    ``batch_size`` on the bare model.
    ``features(batches, split)`` ("Train" or "Val") attaches each batch's
    ``clip_features``; the steps then feed them to the model.
    ``augment(batches, epoch)``, when given, takes the place of ``features``
    for the training batches: it augments them (and attaches their features
    itself, in the CLIP recipe)."""
    device = next(model.parameters()).device
    sw = None
    if weighted_ce and static_weights:
        sw = torch.from_numpy(compute_static_weights(train_ds, batch_size)).to(device)
        if verbose:
            print(f"Computed class weights: {sw.cpu().numpy()}")
    loss_kw = dict(weight_ce=ce_weight, weight_dice=dice_weight,
                   dynamic_weights=weighted_ce and not static_weights, static_weights=sw)
    use_clip = features is not None

    start_epoch, best, es_state, step = 0, None, None, 0
    if resume:
        meta = restore_checkpoint(resume, model, optimizer)
        start_epoch = meta.get("epoch", 0)
        best = meta.get("best_metric")
        es_state = meta.get("early_stopping")
        step = meta["step"]
        if verbose:
            print(f"Resumed from epoch {start_epoch}")

    if isinstance(mesh, SpatialGrid):
        trained = SpatialParallel(model, mesh)
    else:
        trained = wrap(model) if mesh is not None else model
    train_step = make_accum_train_step(
        trained, optimizer, make_segmentation_loss_fn(use_clip=use_clip, **loss_kw), grad_accum)
    eval_step = make_segmentation_eval_step(model, use_clip=use_clip, **loss_kw)
    local_batch = mesh.local_batch(batch_size) if mesh is not None else batch_size

    def attach(batches, split):
        return batches if features is None else features(batches, split)

    def train_batches(epoch):
        batches = batch_iterator(train_ds, local_batch, shuffle=True, seed=seed * 1000 + epoch,
                                 drop_last=True, num_threads=num_threads)
        return attach(batches, "Train") if augment is None else augment(batches, epoch)

    def val_batches():
        return attach(batch_iterator(val_ds, batch_size, num_threads=num_threads), "Val")

    return train_loop(
        trained, optimizer,
        train_step=train_step,
        eval_step=eval_step,
        train_batches=train_batches,
        val_batches=val_batches,
        lr_schedule=poly_lr(lr, epochs),
        epochs=epochs,
        output_dir=output_dir,
        task="segmentation",
        dropout_seed=seed + 1,
        step=step,
        save_every=save_every,
        patience=patience,
        start_epoch=start_epoch,
        best_metric=best,
        early_stopping_state=es_state,
        arch_config=arch_config,
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
    visualize_samples: int = 0,
    num_threads: int = 8,
    verbose: bool = True,
) -> Dict:
    """Evaluate a checkpoint directory, or a reference ``.pth`` (such as
    the JAX package's ``cli export_torch`` writes), on ``Test/`` at each
    image's original resolution."""
    if visualize_samples > 0:
        raise not_ported("--visualize_samples", 8)
    device = default_device(device)
    model = restore_params(model_path, build_model(dtype, device)).eval()

    test_ds = PetDataset(
        Path(data_dir) / "Test" / "resized",
        Path(data_dir) / "Test" / "processed_labels",
        include_augmented=False,
    )
    if verbose:
        print(f"Test dataset size: {len(test_ds)} images")

    @torch.inference_mode()
    def predict_fn(batch):
        images = to_device(batch["image"], device).to(dtype)
        return torch.argmax(model(images), dim=-1).to(torch.int32)

    return evaluate_segmentation(predict_fn, test_ds, batch_size, output_dir,
                                 num_threads=num_threads, verbose=verbose)
