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
loss.

The figures (``utils/visualize.py``, matplotlib): at every checkpoint the
first validation images' original | reconstruction | error strips go to
``reconstructions/epoch_{n}.png``; without matplotlib the snapshot prints one
line and training goes on (JAX skips a snapshot on any error; here any other
error propagates). ``evaluate`` with ``visualize_samples`` > 0 writes
``reconstruction_comparison.png`` of the first test images, and with
``analyze_latent_space`` the PCA and t-SNE of the test images' bottlenecks
(``analyze_latent``, scikit-learn).
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from unet_implementations_tpu_torch import default_device
from unet_implementations_tpu_torch.data.loader import PetDataset, batch_iterator
from unet_implementations_tpu_torch.data.pipeline import is_cat_image
from unet_implementations_tpu_torch.models.unet import UNet, autoencoder_6stage
from unet_implementations_tpu_torch.ops.losses import FeatureFns, reconstruction_loss
from unet_implementations_tpu_torch.ops.normalize import normalize_image
from unet_implementations_tpu_torch.parallel.distributed import is_primary
from unet_implementations_tpu_torch.parallel.mesh import create_mesh, stripe, wrap
from unet_implementations_tpu_torch.recipes.common import check_grad_accum, evaluate_reconstruction
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
from unet_implementations_tpu_torch.utils.visualize import require_matplotlib, save_comparison_grid

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
    verbose: bool = True,
) -> Dict:
    """Train the autoencoder from scratch (or from ``resume``, a checkpoint
    directory) and return the loop's result. After each checkpoint (rank 0
    alone under data parallelism) the first ``min(4, batch_size)``
    validation images and their reconstructions are drawn to
    ``reconstructions/epoch_{n}.png``."""
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

    def save_recon_samples(model: nn.Module, epoch: int) -> None:
        try:
            require_matplotlib("the reconstruction snapshot")
        except ImportError as e:
            if verbose:
                print(f"reconstruction snapshot of epoch {epoch} not drawn: {e}")
            return
        model.eval()
        try:
            save_comparison(model, val_ds, min(4, batch_size), dtype,
                            output_dir / "reconstructions" / f"epoch_{epoch}.png")
        finally:
            model.train()

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
        checkpoint_callback=save_recon_samples,
        mesh=mesh,
        verbose=verbose,
    )


def save_comparison(model: nn.Module, dataset: PetDataset, n: int, dtype: torch.dtype,
                    path: Path) -> None:
    """The first ``n`` images of ``dataset`` (reconstruction mode, uint8)
    beside ``model``'s reconstructions, drawn by ``save_comparison_grid``."""
    batches = batch_iterator(dataset, n, num_threads=1)
    try:
        first = next(batches)
    finally:
        batches.close()
    device = next(model.parameters()).device
    with torch.inference_mode():
        images = normalize_image(to_device(first["image"], device), mode="unit")
        recon = model(images.to(dtype))
    path.parent.mkdir(parents=True, exist_ok=True)
    save_comparison_grid(images.float().cpu().numpy(), recon.float().cpu().numpy(), path)


def require_latent_packages() -> None:
    """Raise ``ImportError`` unless scikit-learn and matplotlib import."""
    try:
        import sklearn  # noqa: F401
    except ImportError as e:
        raise ImportError(f"--analyze_latent_space needs scikit-learn, which cannot be "
                          f"imported ({e})") from e
    require_matplotlib("--analyze_latent_space")


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
    as ``reconstruction_metrics.json``. ``visualize_samples`` > 0 also draws
    ``reconstruction_comparison.png`` of the first ``min(8, batch_size)``
    test images (JAX draws it in every evaluate; its CLI's default of 3 does
    here too). ``analyze_latent_space`` adds ``results["latent_analysis"]``
    (``analyze_latent``). The packages each needs are checked before the
    model loads; under a process group only rank 0 writes."""
    if visualize_samples > 0:
        require_matplotlib("--visualize_samples", "--visualize_samples 0")
    if analyze_latent_space:
        require_latent_packages()
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

    results = evaluate_reconstruction(recon_fn, test_ds, batch_size, output_dir,
                                      num_threads=num_threads, verbose=verbose)
    if visualize_samples > 0 and output_dir is not None and is_primary() and len(test_ds):
        save_comparison(model, test_ds, min(8, batch_size), dtype,
                        Path(output_dir) / "reconstruction_comparison.png")
    if analyze_latent_space:
        results["latent_analysis"] = analyze_latent(model, test_ds, output_dir, batch_size,
                                                    dtype, num_threads, verbose)
    return results


def encode(model: UNet, dataset: PetDataset, batch_size: int = 32,
           dtype: torch.dtype = torch.bfloat16, num_threads: int = 8) -> np.ndarray:
    """The flattened bottleneck of every image of ``dataset``
    (reconstruction mode), (N, H'·W'·C) float32, in the dataset's order: the
    forward with ``return_bottleneck`` on the model's device."""
    device = next(model.parameters()).device
    zs = []
    with torch.inference_mode():
        for batch in batch_iterator(dataset, batch_size, num_threads=num_threads):
            images = normalize_image(to_device(batch["image"], device), mode="unit")
            zs.append(model(images.to(dtype), return_bottleneck=True)[1].float().cpu().numpy())
    return np.concatenate(zs)


def analyze_latent(model: UNet, test_ds: PetDataset, output_dir: str | Path,
                   batch_size: int = 32, dtype: torch.dtype = torch.bfloat16,
                   num_threads: int = 8, verbose: bool = True) -> Dict:
    """PCA and t-SNE scatters of the test images' flattened bottlenecks,
    coloured by the breed in each file name (cat or dog):
    ``latent_space_pca.png`` and, with at least 10 images,
    ``latent_space_tsne.png`` (``init="pca"``, perplexity ``min(30, max(2,
    n // 4))``), as JAX's. Returns ``{"pca_explained": None, "n": n}``.
    Needs scikit-learn and matplotlib (checked before the first encode)."""
    require_latent_packages()
    from sklearn.decomposition import PCA
    from sklearn.manifold import TSNE

    z = encode(model, test_ds, batch_size, dtype, num_threads)
    labels = np.array([1 if is_cat_image(p.stem) else 2 for p in test_ds.image_files])[:len(z)]
    out = {"pca_explained": None, "n": int(len(z))}
    if not is_primary():
        return out
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    scatters = [("PCA", "latent_space_pca.png", PCA(n_components=2).fit_transform(z))]
    if len(z) >= 10:
        tsne = TSNE(n_components=2, init="pca", perplexity=min(30, max(2, len(z) // 4)))
        scatters.append(("t-SNE", "latent_space_tsne.png", tsne.fit_transform(z)))
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    for title, name, xy in scatters:
        fig, ax = plt.subplots(figsize=(8, 6))
        for cls, label, color in [(1, "cat", "tab:red"), (2, "dog", "tab:green")]:
            sel = labels == cls
            ax.scatter(xy[sel, 0], xy[sel, 1], s=8, label=label, color=color)
        ax.legend()
        ax.set_title(f"Latent space ({title})")
        fig.savefig(output_dir / name, dpi=120)
        plt.close(fig)
    if verbose:
        print(f"latent analysis: {len(z)} images -> {output_dir}")
    return out
