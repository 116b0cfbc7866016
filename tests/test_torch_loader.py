"""The port's data loader and early stopping (unet_implementations_tpu_torch)
against the JAX package's.

On a dataset written with cv2 to a temporary directory (originals of several
sizes other than the target, an ``augmented/`` directory, stray mask values
3 and 7 beside {0, 1, 2, 255}):

- every ``PetDataset`` item equals JAX's bit for bit, in the uint8 path
  (``emit_uint8``), the normalized float path and the [0, 1] path;
- the decode cache gives the same items as the direct decode, lives in the
  directory JAX's would, and a cache that JAX built opens without a rebuild;
- ``batch_iterator``'s batches and index order equal JAX's, with and
  without ``shuffle`` and ``drop_last``, and so do the multi-process shards;
- without cv2 a decode raises, and gives no blank sample;
- ``EarlyStopping`` gives JAX's counters and stop epoch in both modes.
"""

import json
import sys

import cv2
import numpy as np
import pytest

from unet_implementations_tpu.data import loader as jax_loader
from unet_implementations_tpu.training.early_stopping import EarlyStopping as JaxEarlyStopping
from unet_implementations_tpu_torch.data import loader
from unet_implementations_tpu_torch.training.early_stopping import EarlyStopping

TARGET = (48, 48)
# Original (h, w) of the base images; the augmented ones take the first two.
ORIGINALS = [(40, 56), (64, 48), (33, 71), (48, 48), (80, 20)]


def write_dataset(root, originals=ORIGINALS, n_augmented=2, seed=0):
    """``root/Train/{resized,resized_label}`` and ``root/Train/augmented/
    {images,masks}``: jpg images and png masks with values {0,1,2,255} and
    strays 3 and 7. Returns (images_dir, masks_dir)."""
    rng = np.random.default_rng(seed)
    images, masks = root / "Train" / "resized", root / "Train" / "resized_label"
    aug_images, aug_masks = root / "Train" / "augmented" / "images", \
        root / "Train" / "augmented" / "masks"
    for d in (images, masks, aug_images, aug_masks):
        d.mkdir(parents=True)

    def write(img_dir, mask_dir, stem, hw):
        cv2.imwrite(str(img_dir / f"{stem}.jpg"),
                    rng.integers(0, 256, (*hw, 3)).astype(np.uint8))
        cv2.imwrite(str(mask_dir / f"{stem}.png"),
                    rng.choice(np.array([0, 1, 2, 255, 3, 7], np.uint8), size=hw))

    for i, hw in enumerate(originals):
        write(images, masks, f"img_{i}", hw)
    for i in range(n_augmented):
        write(aug_images, aug_masks, f"aug_{i}", originals[i])
    return images, masks


@pytest.fixture
def dataset_dirs(tmp_path):
    return write_dataset(tmp_path / "data")


def _items(ds):
    return [ds.load_item(i) for i in range(len(ds))]


def _assert_items_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


class TestPetDataset:
    @pytest.mark.parametrize("kwargs", [
        {"emit_uint8": True},
        {"emit_uint8": False},
        {"emit_uint8": False, "normalize": False},
        {"emit_uint8": True, "include_augmented": False},
    ], ids=["uint8", "normalized", "unit", "no_augmented"])
    def test_items_equal_jax(self, dataset_dirs, kwargs):
        images, masks = dataset_dirs
        ours = loader.PetDataset(images, masks, target_size=TARGET, **kwargs)
        ref = jax_loader.PetDataset(images, masks, target_size=TARGET, **kwargs)
        assert [p.name for p in ours.image_files] == [p.name for p in ref.image_files]
        assert len(ours) == len(ORIGINALS) + (2 if kwargs.get("include_augmented", True) else 0)
        got = _items(ours)
        _assert_items_equal(got, _items(ref))
        # The stray values 3 and 7 are cleared; the original sizes are kept.
        for item, name in zip(got, ours.image_files):
            assert set(np.unique(item["mask"])) <= {0, 1, 2, 255}
            stem = int(name.stem.split("_")[1])
            assert tuple(item["original_dims"]) == ORIGINALS[stem]

    def test_no_masks(self, dataset_dirs):
        images, _ = dataset_dirs
        ours = _items(loader.PetDataset(images, None, target_size=TARGET))
        _assert_items_equal(ours, _items(jax_loader.PetDataset(images, None, target_size=TARGET)))
        assert "mask" not in ours[0]

    @pytest.mark.parametrize("emit_uint8", [True, False])
    def test_cache_round_trip(self, dataset_dirs, tmp_path, emit_uint8):
        images, masks = dataset_dirs
        direct = _items(loader.PetDataset(images, masks, target_size=TARGET,
                                          emit_uint8=emit_uint8))
        cache = tmp_path / "cache"
        built = loader.PetDataset(images, masks, target_size=TARGET, emit_uint8=emit_uint8,
                                  cache_dir=cache)
        d = built.cache_path(cache)
        assert [p.name for p in cache.iterdir()] == [d.name]
        assert json.loads((d / loader.MANIFEST).read_text()) == loader.cache_identity(
            built.image_files, TARGET, True)
        _assert_items_equal(_items(built), direct)
        # A second open reads the cache as it is.
        stamp = (d / "images.npy").stat().st_mtime_ns
        reopened = loader.PetDataset(images, masks, target_size=TARGET, emit_uint8=emit_uint8,
                                     cache_dir=cache)
        assert (d / "images.npy").stat().st_mtime_ns == stamp
        _assert_items_equal(_items(reopened), direct)

    def test_cache_shared_with_jax(self, dataset_dirs, tmp_path, monkeypatch):
        """A cache the JAX package built opens in the port without a decode,
        and the environment variable selects it."""
        images, masks = dataset_dirs
        cache = tmp_path / "cache"
        monkeypatch.setenv("UNET_TPU_DECODE_CACHE", str(cache))
        ref = jax_loader.PetDataset(images, masks, target_size=TARGET, emit_uint8=True)
        monkeypatch.setattr(loader.PetDataset, "_decode", lambda self, idx: 1 / 0)
        ours = loader.PetDataset(images, masks, target_size=TARGET, emit_uint8=True)
        _assert_items_equal(_items(ours), _items(ref))

    def test_stale_cache_rebuilt(self, dataset_dirs, tmp_path):
        images, masks = dataset_dirs
        cache = tmp_path / "cache"
        loader.PetDataset(images, masks, target_size=TARGET, cache_dir=cache)
        cv2.imwrite(str(images / "img_0.jpg"), np.full((30, 30, 3), 200, np.uint8))
        rebuilt = loader.PetDataset(images, masks, target_size=TARGET, cache_dir=cache)
        _assert_items_equal(_items(rebuilt),
                            _items(loader.PetDataset(images, masks, target_size=TARGET)))

    def test_write_cache_from_arrays(self, dataset_dirs, tmp_path, monkeypatch):
        """``write_cache`` with raw items made elsewhere serves a dataset
        that decodes no file (the card's warm-cache path)."""
        images, masks = dataset_dirs
        ref = loader.PetDataset(images, masks, target_size=TARGET, include_augmented=False)
        raws = [ref._decode(i) for i in range(len(ref))]
        cache = tmp_path / "cache"
        loader.write_cache(loader.cache_path(cache, images, masks, TARGET),
                           loader.cache_identity(ref.image_files, TARGET, True),
                           iter(raws), len(raws), TARGET, True)
        monkeypatch.setitem(sys.modules, "cv2", None)
        ours = loader.PetDataset(images, masks, target_size=TARGET, include_augmented=False,
                                 cache_dir=cache)
        _assert_items_equal(_items(ours), [ref._finalize(r) for r in raws])
        with pytest.raises(ValueError, match="items for"):
            loader.write_cache(tmp_path / "short", {}, iter(raws[:2]), 3, TARGET, True)

    def test_decode_without_cv2_raises(self, dataset_dirs, monkeypatch, capsys):
        images, masks = dataset_dirs
        ds = loader.PetDataset(images, masks, target_size=TARGET)
        monkeypatch.setitem(sys.modules, "cv2", None)
        with pytest.raises(ImportError):
            ds.load_item(0)
        assert "Error loading" not in capsys.readouterr().out

    def test_unreadable_file_gives_blank_sample(self, dataset_dirs, capsys):
        images, masks = dataset_dirs
        (images / "img_2.jpg").write_bytes(b"not a jpeg")
        ours = loader.PetDataset(images, masks, target_size=TARGET, include_augmented=False)
        ref = jax_loader.PetDataset(images, masks, target_size=TARGET, include_augmented=False)
        _assert_items_equal([ours.load_item(2)], [ref.load_item(2)])
        assert "Error loading image or mask" in capsys.readouterr().out

    @pytest.mark.parametrize("count", [2, 3])
    def test_process_shards_equal_jax(self, dataset_dirs, count):
        images, masks = dataset_dirs
        for index in range(count):
            ours = loader.PetDataset(images, masks, target_size=TARGET,
                                     process_index=index, process_count=count)
            ref = jax_loader.PetDataset(images, masks, target_size=TARGET,
                                        process_index=index, process_count=count)
            assert ours.image_files == ref.image_files
            assert len(ours) == -(-(len(ORIGINALS) + 2) // count)


class TestBatchIterator:
    @pytest.mark.parametrize("shuffle,drop_last,batch", [
        (False, False, 3), (True, False, 3), (True, True, 3), (False, True, 2), (True, True, 4),
    ])
    def test_batches_equal_jax(self, dataset_dirs, shuffle, drop_last, batch):
        images, masks = dataset_dirs
        kw = dict(target_size=TARGET, emit_uint8=True)
        ours = list(loader.batch_iterator(loader.PetDataset(images, masks, **kw), batch,
                                          shuffle=shuffle, seed=7, drop_last=drop_last,
                                          num_threads=3))
        ref = list(jax_loader.batch_iterator(jax_loader.PetDataset(images, masks, **kw), batch,
                                             shuffle=shuffle, seed=7, drop_last=drop_last,
                                             num_threads=3))
        assert len(ours) == len(ref)
        n = len(ORIGINALS) + 2
        assert sum(len(b["index"]) for b in ours) == (n // batch * batch if drop_last else n)
        for a, b in zip(ours, ref):
            assert a.keys() == b.keys() == {"image", "mask", "original_dims", "index"}
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        order = np.concatenate([b["index"] for b in ours])
        assert (order != np.sort(order)).any() == shuffle

    def test_empty(self, tmp_path):
        (tmp_path / "empty").mkdir()
        assert list(loader.batch_iterator(loader.PetDataset(tmp_path / "empty"), 2)) == []


@pytest.mark.parametrize("mode,scores", [
    ("max", [0.1, 0.2, 0.2005, 0.15, 0.3, 0.2999, 0.1, 0.1, 0.1]),
    ("min", [1.0, 0.9, 0.8995, 0.95, 0.5, 0.5005, 0.6, 0.7, 0.6]),
])
def test_early_stopping_equals_jax(mode, scores):
    ours = EarlyStopping(patience=3, mode=mode, verbose=False)
    ref = JaxEarlyStopping(patience=3, mode=mode, verbose=False)
    stops = []
    for epoch, score in enumerate(scores):
        assert ours(score) == ref(score)
        assert ours.state_dict() == ref.state_dict()
        if ours.early_stop:
            stops.append(epoch)
    assert stops == [7, 8]
    resumed = EarlyStopping(patience=3, mode=mode, verbose=False).load_state_dict(
        ref.state_dict())
    assert resumed.state_dict() == ours.state_dict()
    with pytest.raises(ValueError):
        EarlyStopping(mode="up")
