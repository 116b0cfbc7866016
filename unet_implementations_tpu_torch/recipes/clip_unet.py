"""CLIP_UNet recipe: a frozen CLIP image embedding fused at the UNet bottleneck.

Counterpart of ``unet_implementations_tpu/recipes/clip_unet.py``: the
6-stage UNet with ``clip_fusion`` (``models/unet.py``), trained as the
``our_unet`` recipe trains (SGD-Nesterov with poly LR, Dice + weighted CE,
early stopping on mean foreground Dice; batch 16 by default), on features
from the frozen ViT tower (``models/clip.py``, ViT-B/16 by default).

The tower is frozen and deterministic, so training computes its embeddings
once per dataset into a table indexed by dataset index (JAX's
``embedding_cache``, which no command turns off), or reads the per-split
``.npz`` tables ``dump_embeddings`` (``cli clip_unet embed``) writes:
``embeddings`` (N, dim) float32, ``files`` (the image names, row-aligned)
and ``model`` (the encoder's name), the JAX package's fields, so either
package reads the other's tables. A table built with another encoder, or
missing a file, is not used: its rows are then computed anew (in training)
or extracted live (in evaluation), as JAX does.

With ``online_augment`` the training batches are augmented on the device and
the tower embeds the 224² view of each augmented batch live
(``recipes/common.py::wrap_online_augment_clip``): no Train table is read or
computed, and validation keeps its table. Without ``clip_weights`` the tower
runs on random weights drawn from seed 0 in every command, so tables and live
extraction agree. Evaluation conditions on the features unless
``use_clip_features=False`` (the reference evaluator's quirk). Gradient
accumulation splits the features with their rows, and training is
data-parallel under a process group as in ``recipes/our_unet.py`` (each rank
builds the tables of its own stripe). Not ported (it raises
``NotImplementedError``): the evaluation's visualizations.
"""

from __future__ import annotations

import functools
from pathlib import Path
from typing import Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from unet_implementations_tpu_torch import default_device
from unet_implementations_tpu_torch.data.loader import PetDataset, batch_iterator
from unet_implementations_tpu_torch.models.clip import CLIP_CONFIGS, ClipFeatureExtractor
from unet_implementations_tpu_torch.models.unet import UNet, unet_6stage
from unet_implementations_tpu_torch.parallel.mesh import create_mesh, stripe
from unet_implementations_tpu_torch.recipes import our_unet
from unet_implementations_tpu_torch.recipes.common import (
    check_grad_accum,
    evaluate_segmentation,
    not_ported,
    wrap_online_augment_clip,
)
from unet_implementations_tpu_torch.training.checkpoint import restore_params
from unet_implementations_tpu_torch.training.loop import write_training_config
from unet_implementations_tpu_torch.training.steps import to_device
from unet_implementations_tpu_torch.training.train_state import sgd_nesterov

# The tower's random weights, when no checkpoint is given, in every command.
CLIP_SEED = 0


def arch_config(clip_dim: int = 512) -> dict:
    return dict(our_unet.ARCH_CONFIG, with_clip_features=True, clip_dim=clip_dim)


ARCH_CONFIG = arch_config()


def build_model(dtype: torch.dtype = torch.bfloat16, device=None, seed: int = 0,
                clip_dim: int = 512) -> UNet:
    """``unet_6stage`` with the bottleneck fusion; ``clip_dim`` follows the
    encoder (512 for ViT-B/16 and B/32, 768 for ViT-L/14)."""
    return unet_6stage(dtype=dtype, device=device, generator=torch.Generator().manual_seed(seed),
                       clip_fusion=True, clip_dim=clip_dim)


def make_datasets(data_dir: str | Path, include_augmented: bool = True,
                  emit_uint8: bool = True, train_clip_view: bool = True,
                  process_index: int = 0, process_count: int = 1):
    """Train and validation datasets with the CLIP view from each split's
    ``resized_clip/`` (or one resize of each file's decode where it is
    missing). ``emit_uint8``: uint8 pixels and views, normalized on the
    device. ``train_clip_view=False`` leaves the view out of the training
    items (online augmentation makes its own from the augmented pixels).
    The training set is the ``process_index``-th of ``process_count``
    stripes; validation is not striped."""
    data_dir = Path(data_dir)
    train = PetDataset(
        data_dir / "Train" / "resized",
        data_dir / "Train" / "resized_label",
        include_augmented=include_augmented,
        emit_uint8=emit_uint8,
        clip_dir=data_dir / "Train" / "resized_clip" if train_clip_view else None,
        process_index=process_index,
        process_count=process_count,
    )
    val = PetDataset(
        data_dir / "Val" / "resized",
        data_dir / "Val" / "processed_labels",
        include_augmented=False,
        emit_uint8=emit_uint8,
        clip_dir=data_dir / "Val" / "resized_clip",
    )
    return train, val


def _embedding_table(extractor: ClipFeatureExtractor, dataset: PetDataset,
                     batch_size: int = 64) -> np.ndarray:
    """(len(dataset), dim) float32 embeddings, indexed by dataset index."""
    feats = np.zeros((len(dataset), extractor.output_dim), np.float32)
    for batch in batch_iterator(dataset, batch_size, shuffle=False):
        feats[batch["index"]] = extractor(batch["clip_image"]).cpu().numpy()
    return feats


def _table_file(embeddings_dir: str | Path, split: str) -> Path:
    return Path(embeddings_dir) / f"clip_embeddings_{split.lower()}.npz"


def dump_embeddings(
    data_dir: str | Path,
    output_dir: Optional[str | Path] = None,
    *,
    clip_model: str = "ViT-B/16",
    clip_weights: Optional[str] = None,
    batch_size: int = 64,
    splits: Tuple[str, ...] = ("Train", "Val", "Test"),
    include_augmented: bool = True,
    dtype: torch.dtype = torch.bfloat16,
    device=None,
    verbose: bool = True,
) -> Dict[str, str]:
    """Write each split's embedding table to
    ``output_dir/clip_embeddings_{split}.npz`` (default ``output_dir``:
    ``data_dir/clip_embeddings``); a split without ``resized/`` is skipped.
    Returns {split: path}."""
    data_dir = Path(data_dir)
    out = Path(output_dir) if output_dir is not None else data_dir / "clip_embeddings"
    extractor = ClipFeatureExtractor(clip_model, clip_weights, dtype=dtype, device=device,
                                     seed=CLIP_SEED)
    out.mkdir(parents=True, exist_ok=True)
    written = {}
    for split in splits:
        images = data_dir / split / "resized"
        if not images.exists():
            if verbose:
                print(f"embed: skipping {split} (no {images})")
            continue
        ds = PetDataset(images, None, include_augmented=include_augmented and split == "Train",
                        clip_dir=data_dir / split / "resized_clip")
        table = _embedding_table(extractor, ds, batch_size)
        path = _table_file(out, split)
        np.savez(path, embeddings=table, files=np.asarray([f.name for f in ds.image_files]),
                 model=np.asarray(clip_model))
        written[split] = str(path)
        if verbose:
            print(f"embed: {split}: {table.shape} -> {path}")
    return written


def _load_embedding_table(embeddings_dir: str | Path, split: str, dataset: PetDataset,
                          clip_model: str, verbose: bool = True) -> Optional[np.ndarray]:
    """A dumped table with its rows re-aligned to ``dataset``'s file order,
    or None (the caller then runs the tower itself) when the file is absent,
    was built with another encoder, or lacks a file of the dataset."""
    path = _table_file(embeddings_dir, split)
    if not path.exists():
        if verbose:
            print(f"embed cache: {path} not found; not used")
        return None
    data = np.load(path, allow_pickle=False)
    if str(data["model"]) != clip_model:
        if verbose:
            print(f"embed cache: {path} was built with {data['model']}, not {clip_model}; "
                  f"not used")
        return None
    rows = {name: i for i, name in enumerate(data["files"])}
    missing = [f.name for f in dataset.image_files if f.name not in rows]
    if missing:
        if verbose:
            print(f"embed cache: {missing[0]} missing from {path}; not used")
        return None
    idx = np.asarray([rows[f.name] for f in dataset.image_files], np.int64)
    return np.ascontiguousarray(data["embeddings"][idx])


def _attach_features(batches: Iterable[Dict], table: np.ndarray) -> Iterator[Dict]:
    """Each batch with ``clip_features``: the table's rows of its dataset
    indices; the CLIP view itself is dropped."""
    for batch in batches:
        batch = dict(batch, clip_features=table[batch["index"]])
        batch.pop("clip_image", None)
        yield batch


def train(
    data_dir: str | Path,
    output_dir: str | Path,
    *,
    clip_model: str = "ViT-B/16",
    clip_weights: Optional[str] = None,
    embeddings_dir: Optional[str | Path] = None,
    batch_size: int = 16,
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
    use_mesh: bool = True,
    num_threads: int = 8,
    online_augment: bool = False,
    grad_accum: int = 1,
    verbose: bool = True,
) -> Dict:
    """Train from scratch (or from ``resume``) on the frozen encoder's
    features: the tables of ``embeddings_dir`` where they fit the datasets,
    else tables computed once here; with ``online_augment`` the training
    batches' features are extracted live from the augmented pixels. Returns
    the loop's result."""
    check_grad_accum(batch_size, grad_accum, use_mesh=use_mesh)
    device = default_device(device)
    mesh = create_mesh(device) if use_mesh else None
    output_dir = Path(output_dir)
    write_training_config(output_dir, dict(
        data_dir=str(data_dir), output_dir=str(output_dir),
        clip_model=clip_model, clip_weights=clip_weights,
        embedding_cache=True, batch_size=batch_size, epochs=epochs,
        lr=lr, weight_decay=weight_decay, momentum=momentum,
        weighted_ce=weighted_ce, static_weights=static_weights,
        dice_weight=dice_weight, ce_weight=ce_weight, patience=patience,
        save_every=save_every, seed=seed, dtype=str(dtype),
        with_clip_features=True, online_augment=online_augment,
        grad_accum=grad_accum,
    ))

    train_ds, val_ds = make_datasets(data_dir, include_augmented=not online_augment,
                                     train_clip_view=not online_augment, **stripe(mesh))
    if verbose:
        print(f"Training dataset size: {len(train_ds)}")
        print(f"Validation dataset size: {len(val_ds)}")

    if verbose and clip_weights is None:
        print("WARNING: no CLIP weights given: the encoder runs on random weights "
              "(pass --clip_weights to load a torch CLIP checkpoint).")
    # With online augmentation the Train features come live from the
    # augmented pixels: no Train table is read or computed.
    datasets = {"Val": val_ds} if online_augment else {"Train": train_ds, "Val": val_ds}
    tables = {split: None if embeddings_dir is None else
              _load_embedding_table(embeddings_dir, split, ds, clip_model, verbose)
              for split, ds in datasets.items()}
    missing = [split for split, table in tables.items() if table is None]
    extractor = (ClipFeatureExtractor(clip_model, clip_weights, dtype=dtype, device=device,
                                      seed=CLIP_SEED) if missing or online_augment else None)
    if missing and verbose:
        print("Precomputing CLIP embeddings (frozen encoder, computed once)...")
    for split in missing:
        tables[split] = _embedding_table(extractor, datasets[split])
    augment = (functools.partial(wrap_online_augment_clip, seed=seed, device=device,
                                 extractor=extractor, rank=mesh.data_rank if mesh else 0)
               if online_augment else None)
    del extractor  # the tower stays only for live extraction

    clip_dim = CLIP_CONFIGS[clip_model].output_dim
    model = build_model(dtype, device, seed, clip_dim=clip_dim)
    optimizer = sgd_nesterov(model.parameters(), lr, weight_decay, momentum)
    return our_unet.fit(
        model, optimizer, train_ds, val_ds, output_dir, batch_size=batch_size, epochs=epochs,
        lr=lr, weighted_ce=weighted_ce, static_weights=static_weights,
        dice_weight=dice_weight, ce_weight=ce_weight, patience=patience,
        save_every=save_every, resume=resume, seed=seed, num_threads=num_threads,
        arch_config=arch_config(clip_dim), verbose=verbose, grad_accum=grad_accum, mesh=mesh,
        features=lambda batches, split: _attach_features(batches, tables[split]),
        augment=augment)


def evaluate(
    model_path: str | Path,
    data_dir: str | Path,
    output_dir: str | Path,
    *,
    batch_size: int = 16,
    dtype: torch.dtype = torch.bfloat16,
    device=None,
    clip_model: str = "ViT-B/16",
    clip_weights: Optional[str] = None,
    embeddings_dir: Optional[str | Path] = None,
    use_clip_features: bool = True,
    visualize_samples: int = 0,
    num_threads: int = 8,
    verbose: bool = True,
) -> Dict:
    """Evaluate a checkpoint directory or a reference ``.pth`` on ``Test/``
    at each image's original resolution: conditioned on the Test table of
    ``embeddings_dir`` where it fits, else on live extraction; with
    ``use_clip_features=False`` unconditioned (the fusion is skipped)."""
    if visualize_samples > 0:
        raise not_ported("--visualize_samples", 8)
    device = default_device(device)
    clip_dim = CLIP_CONFIGS[clip_model].output_dim
    model = restore_params(model_path, build_model(dtype, device, clip_dim=clip_dim)).eval()

    data_dir = Path(data_dir)
    test_ds = PetDataset(
        data_dir / "Test" / "resized",
        data_dir / "Test" / "processed_labels",
        include_augmented=False,
        clip_dir=data_dir / "Test" / "resized_clip",
    )
    if verbose:
        print(f"Test dataset size: {len(test_ds)} images")
        if not use_clip_features:
            print("NOTE: evaluating WITHOUT clip conditioning "
                  "(the reference evaluator's quirk)")

    table = None
    if use_clip_features and embeddings_dir is not None:
        table = _load_embedding_table(embeddings_dir, "Test", test_ds, clip_model, verbose)
    extractor = (ClipFeatureExtractor(clip_model, clip_weights, dtype=dtype, device=device,
                                      seed=CLIP_SEED)
                 if use_clip_features and table is None else None)

    @torch.inference_mode()
    def predict_fn(batch):
        images = to_device(batch["image"], device).to(dtype)
        if table is not None:
            features = to_device(table[batch["index"]], device)
        elif extractor is not None:
            features = extractor(batch["clip_image"])
        else:
            features = None
        return torch.argmax(model(images, features), dim=-1).to(torch.int32)

    return evaluate_segmentation(predict_fn, test_ds, batch_size, output_dir,
                                 num_threads=num_threads, verbose=verbose)
