"""Host-side dataset and threaded prefetching batch loader.

The port's own copy of ``unet_implementations_tpu/data/loader.py`` in its
segmentation and reconstruction modes. It yields NHWC numpy batches; the
train and eval steps move them to the device:

- images: cv2 BGR->RGB, LINEAR resize to 512², then either raw uint8
  (``emit_uint8``: the step normalizes on the device, ``ops/normalize.py``)
  or /255 and ImageNet mean/std on the host (``normalize=False`` leaves
  [0, 1]);
- masks: grayscale, NEAREST resize, stray values ``(v > 2) & (v != 255)``
  set to 0, int32;
- original dims recorded before the resize (the eval protocol needs them);
- ``mode="reconstruction"``: no mask in the batch (a masks directory given
  is read only for the original dims), and ``target`` is the image: the raw
  uint8 image with ``emit_uint8``, else both are the image /255 (no ImageNet
  statistics);
- the CLIP view (``clip_dir``): a ``clip_size``² RGB image per item, read
  from ``clip_dir`` (``resized_clip/``, written by ``cli clip_resize``) or,
  for a file missing there, one LINEAR resize of the image's own decode
  (never of its 512² copy); uint8 with ``emit_uint8``, else /255 and
  ImageNet mean/std (the reference's quirk: ImageNet statistics, not
  CLIP's). Reconstruction mode ignores it;
- augmented images from ``../augmented/{images,masks}`` included for train;
- several processes: the file list is split into equal contiguous shards by
  ``process_index`` / ``process_count``.

cv2 is imported only when a file is decoded, so a dataset served from a warm
decode cache runs on a host without cv2.

Decode-once cache: ``cache_dir`` (or env ``UNET_TPU_DECODE_CACHE``) holds a
uint8 memmap of the decoded, resized arrays, built on first use. From then on
the loader reads from the page cache and only the float normalization runs
per batch. ``cache_path``, ``cache_identity`` and ``write_cache`` are module
functions, so a cache can also be written from arrays made elsewhere. The
directory, manifest and arrays (``clips.npy`` for the CLIP view) are those
of the JAX package, so the two packages share a cache.
"""

from __future__ import annotations

import concurrent.futures as cf
import hashlib
import json
import os
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from unet_implementations_tpu_torch.ops.normalize import IMAGENET_MEAN, IMAGENET_STD

MANIFEST = "manifest.json"
MODES = ("segmentation", "reconstruction")


def cache_identity(image_files: Sequence[Path], target_size: Tuple[int, int],
                   has_masks: bool, mode: str = "segmentation", clip_size: int = 0) -> Dict:
    """What a cache was built from: name, size and mtime of every image file
    (a re-run of the offline pipeline or augmentation invalidates it), the
    target size, the mode, whether the dataset has a masks directory (a
    reconstruction cache stores no masks either way) and the CLIP view's
    side (0 without a ``clip_dir``)."""
    return {
        "version": 1,
        "target_size": list(target_size),
        "mode": mode,
        "has_masks": has_masks,
        "clip_size": clip_size,
        "files": [[p.name, st.st_size, st.st_mtime_ns]
                  for p in image_files for st in [p.stat()]],
    }


def cache_path(root: str | Path, images_dir: Path, masks_dir: Optional[Path],
               target_size: Tuple[int, int], process_index: int = 0,
               process_count: int = 1, mode: str = "segmentation", clip_size: int = 0) -> Path:
    """The cache directory of one dataset (one process's shard, one mode, one
    CLIP view side) under ``root``."""
    key = hashlib.sha1(json.dumps(
        [str(images_dir), str(masks_dir), mode, list(target_size), clip_size,
         process_index, process_count]
    ).encode()).hexdigest()[:12]
    return Path(root) / f"{images_dir.parent.name}_{images_dir.name}_{key}"


def write_cache(d: Path, ident: Dict, items: Iterable[Dict[str, np.ndarray]],
                n: int, target_size: Tuple[int, int], has_masks: bool,
                clip_size: int = 0) -> None:
    """Write ``n`` raw items (``{"image": (H, W, 3) uint8, "original_dims":
    (2,) int32, "mask": (H, W) uint8, "clip_image": (S, S, 3) uint8}``, the
    mask only with ``has_masks``, the CLIP view only with ``clip_size`` S >
    0) as the cache in ``d``. The manifest is written last, so a build cut
    short is rebuilt on the next open."""
    th, tw = target_size
    d.mkdir(parents=True, exist_ok=True)
    print(f"decode cache: building {d} ({n} items)...", flush=True)
    mm = np.lib.format.open_memmap
    imgs = mm(d / "images.npy", mode="w+", dtype=np.uint8, shape=(n, th, tw, 3))
    dims = mm(d / "dims.npy", mode="w+", dtype=np.int32, shape=(n, 2))
    masks = (mm(d / "masks.npy", mode="w+", dtype=np.uint8, shape=(n, th, tw))
             if has_masks else None)
    clips = (mm(d / "clips.npy", mode="w+", dtype=np.uint8, shape=(n, clip_size, clip_size, 3))
             if clip_size else None)
    count = 0
    for i, raw in enumerate(items):
        imgs[i] = raw["image"]
        dims[i] = raw["original_dims"]
        if masks is not None:
            masks[i] = raw["mask"]
        if clips is not None:
            clips[i] = raw["clip_image"]
        count += 1
        if count % 2000 == 0:
            print(f"decode cache: {count}/{n}", flush=True)
    if count != n:
        raise ValueError(f"decode cache: {count} items for {n} files")
    for arr in (imgs, dims, masks, clips):
        if arr is not None:
            arr.flush()
    (d / MANIFEST).write_text(json.dumps(ident))
    print(f"decode cache: built {d}", flush=True)


def open_cache(d: Path) -> Dict[str, np.ndarray]:
    cache = {"image": np.load(d / "images.npy", mmap_mode="r"),
             "original_dims": np.load(d / "dims.npy", mmap_mode="r")}
    if (d / "masks.npy").exists():
        cache["mask"] = np.load(d / "masks.npy", mmap_mode="r")
    if (d / "clips.npy").exists():
        cache["clip_image"] = np.load(d / "clips.npy", mmap_mode="r")
    return cache


class PetDataset:
    """File-list dataset over the processed directory schema."""

    def __init__(
        self,
        images_dir: str | Path,
        masks_dir: Optional[str | Path] = None,
        include_augmented: bool = True,
        target_size: Tuple[int, int] = (512, 512),
        process_index: int = 0,
        process_count: int = 1,
        normalize: bool = True,
        cache_dir: Optional[str | Path] = None,
        emit_uint8: bool = False,
        mode: str = "segmentation",
        clip_dir: Optional[str | Path] = None,
        clip_size: int = 224,
    ):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        self.mode = mode
        self.clip_dir = Path(clip_dir) if clip_dir else None
        self.clip_size = clip_size
        self.emit_uint8 = emit_uint8
        self.images_dir = Path(images_dir)
        self.masks_dir = Path(masks_dir) if masks_dir else None
        self.target_size = target_size
        self.normalize = normalize

        self.image_files: List[Path] = sorted(self.images_dir.glob("*.jpg"))
        self.aug_masks_dir: Optional[Path] = None
        self.aug_files = set()
        if include_augmented:
            aug_images = self.images_dir.parent / "augmented" / "images"
            if aug_images.exists():
                self.aug_masks_dir = self.images_dir.parent / "augmented" / "masks"
                aug_list = sorted(aug_images.glob("*.jpg"))
                self.aug_files = set(aug_list)
                self.image_files.extend(aug_list)

        # Equal-size contiguous shards: striding would give processes
        # different counts, and the one with an extra batch would wait in a
        # collective the others never join. The list is padded by wrapping
        # from its start, so no file drops out of every epoch.
        self.process_index = process_index
        self.process_count = process_count
        if process_count > 1:
            files = list(self.image_files)
            if files and len(files) % process_count:
                pad = process_count - len(files) % process_count
                files = files + [files[i % len(files)] for i in range(pad)]
            per_host = len(files) // process_count
            start = process_index * per_host
            self.image_files = files[start:start + per_host]

        # Built after sharding, so each process caches only its own shard.
        if cache_dir is None:
            cache_dir = os.environ.get("UNET_TPU_DECODE_CACHE") or None
        self._cache: Optional[Dict[str, np.ndarray]] = None
        if cache_dir and self.image_files:
            self._cache = self._open_or_build_cache(Path(cache_dir))

    def __len__(self) -> int:
        return len(self.image_files)

    def _mask_path(self, img_path: Path) -> Optional[Path]:
        if self.masks_dir is None:
            return None
        if img_path in self.aug_files and self.aug_masks_dir is not None:
            return self.aug_masks_dir / f"{img_path.stem}.png"
        return self.masks_dir / f"{img_path.stem}.png"

    def load_item(self, idx: int) -> Dict[str, np.ndarray]:
        raw = self._decode(idx) if self._cache is None else self._cached(idx)
        return self._finalize(raw)

    def _decode(self, idx: int) -> Dict[str, np.ndarray]:
        """One file decode -> the uint8 arrays the cache stores: the resized
        RGB image, the resized and clamped mask, the original dims. All float
        math is in ``_finalize``, so a cache round trip equals the direct
        path bit for bit.

        An unreadable file gives a blank sample, as the reference's loader
        does; a missing cv2 raises (it is imported outside that handler)."""
        import cv2

        img_path = self.image_files[idx]
        th, tw = self.target_size
        try:
            image = cv2.imread(str(img_path))
            if image is None:
                raise ValueError(f"Failed to load image: {img_path}")
            image = cv2.cvtColor(image, cv2.COLOR_BGR2RGB)
            mask = None
            mask_path = self._mask_path(img_path)
            if mask_path is not None:
                mask = cv2.imread(str(mask_path), cv2.IMREAD_GRAYSCALE)
                if mask is None:
                    raise ValueError(f"Failed to load mask: {mask_path}")
                original_dims = np.array(mask.shape[:2], np.int32)
            else:
                original_dims = np.array(image.shape[:2], np.int32)
        except (cv2.error, ValueError) as e:
            print(f"Error loading image or mask: {e}")
            image = np.zeros((th, tw, 3), np.uint8)
            mask = np.zeros((th, tw), np.uint8) if self.masks_dir else None
            original_dims = np.array(self.target_size, np.int32)

        # The decode before its resize feeds the CLIP view's fallback: the
        # resized_clip/ images are one resize from the original.
        decoded = image
        if image.shape[:2] != (th, tw):
            image = cv2.resize(image, (tw, th), interpolation=cv2.INTER_LINEAR)
        raw: Dict[str, np.ndarray] = {"image": image, "original_dims": original_dims}
        if mask is not None and self.mode == "segmentation":
            if mask.shape != (th, tw):
                mask = cv2.resize(mask, (tw, th), interpolation=cv2.INTER_NEAREST)
            raw["mask"] = np.where((mask > 2) & (mask != 255), 0, mask).astype(np.uint8)
        if self._clip_cached:
            raw["clip_image"] = self._decode_clip(img_path, decoded)
        return raw

    def _decode_clip(self, img_path: Path, decoded: np.ndarray) -> np.ndarray:
        """The CLIP view of one file: ``clip_dir``'s copy, else one resize of
        the decode; a copy of another side is resized once more, so every
        route is one cv2 resize before any normalization."""
        import cv2

        side = self.clip_size
        clip_path = self.clip_dir / img_path.name
        clip_img = cv2.imread(str(clip_path)) if clip_path.exists() else None
        if clip_img is None:
            clip_img = cv2.resize(decoded, (side, side), interpolation=cv2.INTER_LINEAR)
        else:
            clip_img = cv2.cvtColor(clip_img, cv2.COLOR_BGR2RGB)
        if clip_img.shape[:2] != (side, side):
            clip_img = cv2.resize(clip_img, (side, side), interpolation=cv2.INTER_LINEAR)
        return clip_img

    @property
    def _clip_cached(self) -> bool:
        """Whether items carry the CLIP view (reconstruction ignores it)."""
        return self.clip_dir is not None and self.mode == "segmentation"

    def _finalize(self, raw: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """uint8 arrays -> the batch contract (normalization etc.)."""
        item: Dict[str, np.ndarray] = {"original_dims": raw["original_dims"]}
        if self.mode == "reconstruction":
            image = raw["image"] if self.emit_uint8 else raw["image"].astype(np.float32) / 255.0
            item["image"] = item["target"] = image
            return item
        if self.emit_uint8:
            item["image"] = raw["image"]
        else:
            img_f = raw["image"].astype(np.float32) / 255.0
            item["image"] = (img_f - IMAGENET_MEAN) / IMAGENET_STD if self.normalize else img_f
        if "mask" in raw:
            item["mask"] = raw["mask"].astype(np.int32)
        if "clip_image" in raw:
            if self.emit_uint8:
                item["clip_image"] = raw["clip_image"]
            else:
                clip_f = raw["clip_image"].astype(np.float32) / 255.0
                item["clip_image"] = (clip_f - IMAGENET_MEAN) / IMAGENET_STD
        return item

    # ---- decode-once cache -------------------------------------------------

    @property
    def _clip_key(self) -> int:
        """The CLIP view's side in the cache's identity and key: as in JAX,
        ``clip_size`` whenever a ``clip_dir`` is given (reconstruction mode
        included, though it stores no view), else 0."""
        return self.clip_size if self.clip_dir is not None else 0

    def cache_path(self, root: str | Path) -> Path:
        return cache_path(root, self.images_dir, self.masks_dir, self.target_size,
                          self.process_index, self.process_count, self.mode, self._clip_key)

    def _open_or_build_cache(self, root: Path) -> Dict[str, np.ndarray]:
        has_masks = self.masks_dir is not None
        ident = cache_identity(self.image_files, self.target_size, has_masks, self.mode,
                               self._clip_key)
        d = self.cache_path(root)
        manifest = d / MANIFEST
        if manifest.exists():
            try:
                if json.loads(manifest.read_text()) == ident:
                    return open_cache(d)
            except json.JSONDecodeError:
                pass  # a torn manifest: rebuild below
        with cf.ThreadPoolExecutor(max_workers=8) as pool:
            write_cache(d, ident, pool.map(self._decode, range(len(self))), len(self),
                        self.target_size, has_masks and self.mode == "segmentation",
                        self.clip_size if self._clip_cached else 0)
        return open_cache(d)

    def _cached(self, idx: int) -> Dict[str, np.ndarray]:
        # np.array copies out of the memmap so batches never pin cache pages.
        return {k: np.array(v[idx]) for k, v in self._cache.items()}


def batch_iterator(
    dataset: PetDataset,
    batch_size: int,
    shuffle: bool = False,
    seed: int = 0,
    drop_last: bool = False,
    num_threads: int = 8,
    prefetch: int = 2,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yield stacked numpy batches with threaded decode and prefetch; each
    batch also carries ``index``, the dataset indices of its items."""
    num_threads = max(1, num_threads)
    prefetch = max(1, prefetch)
    indices = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(indices)
    if drop_last:
        indices = indices[: (len(indices) // batch_size) * batch_size]
    if len(indices) == 0:
        return

    chunks = [indices[i:i + batch_size] for i in range(0, len(indices), batch_size)]

    # Per-item futures, not per-batch: every decode in the prefetch window
    # runs on the pool at once (cv2 releases the GIL in imread and resize).
    with cf.ThreadPoolExecutor(max_workers=num_threads) as pool:
        def submit(chunk):
            return [pool.submit(dataset.load_item, int(i)) for i in chunk]

        pending = [submit(c) for c in chunks[:prefetch]]
        next_submit = prefetch
        for i in range(len(chunks)):
            futs = pending[i]
            pending[i] = None  # release consumed futures and their items
            if next_submit < len(chunks):
                pending.append(submit(chunks[next_submit]))
                next_submit += 1
            items = [f.result() for f in futs]
            batch = {k: np.stack([it[k] for it in items]) for k in items[0]}
            batch["index"] = np.asarray(chunks[i], np.int64)
            yield batch
