"""The port's raw-data tools (``data/pipeline.py``, ``data/sanity_checks.py``,
``data/download.py``, ``utils/dataset_analyzer.py``, ``utils/helpers.py``)
against the JAX package's, on the CPU.

The fixture is a raw tree in the archive's extraction layout, as
``tests/test_raw_archive_e2e.py`` builds it: breed file names (cats
capitalised), TrainVal masks {0, 1|2, 255}, 3-channel Test masks whose
foreground is 128, a corrupt jpg with a valid mask and an image without a
mask. Both pipelines run on it with the same seed: the same files in each
split, the same counts, and every file they write (jpgs, pngs, copies) equal
byte for byte. Then ``run_sanity_checks``, ``analyze_dataset``, the helpers,
``extract_archive`` and ``remap_raw_mask``'s branches against JAX's, and the
port's CLI chain ``pipeline -> augment -> sanity_checks -> clip_resize``.
"""

import dataclasses
import random
import tarfile
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

from unet_implementations_tpu.data import download as jax_download
from unet_implementations_tpu.data import pipeline as jax_pipeline
from unet_implementations_tpu.data import sanity_checks as jax_sanity
from unet_implementations_tpu.utils import dataset_analyzer as jax_analyzer
from unet_implementations_tpu.utils import helpers as jax_helpers
from unet_implementations_tpu_torch import cli
from unet_implementations_tpu_torch.data import download, pipeline, sanity_checks
from unet_implementations_tpu_torch.utils import dataset_analyzer, helpers

CATS = [f"Abyssinian_{i}" for i in range(3)] + [f"Persian_{i}" for i in range(2)]
DOGS = [f"beagle_{i}" for i in range(3)] + [f"pug_{i}" for i in range(2)]
TEST = ["Siamese_0", "boxer_1", "Bombay_2"]


def make_raw_archive(root: Path) -> Path:
    """The raw tree under ``root/Dataset_filtered``; returns ``root``."""
    rng = np.random.default_rng(11)
    base = root / "Dataset_filtered"
    tv, te = base / "TrainVal", base / "Test"
    for d in (tv, te):
        (d / "color").mkdir(parents=True)
        (d / "label").mkdir(parents=True)
    for stem in CATS + DOGS:
        cls = 1 if stem[0].isupper() else 2
        h, w = int(rng.integers(120, 260)), int(rng.integers(120, 260))
        img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        img[: h // 2] //= 2
        cv2.imwrite(str(tv / "color" / f"{stem}.jpg"), img)
        m = np.zeros((h, w), np.uint8)
        m[h // 4: h // 2, w // 4: w // 2] = cls
        m[h // 4 - 2: h // 4, w // 4: w // 2] = 255
        Image.fromarray(m).save(tv / "label" / f"{stem}.png")
    # A corrupt jpg with a valid mask, and an image without a mask.
    (tv / "color" / "Bengal_9.jpg").write_bytes(b"\xff\xd8\xff\xe0corrupt")
    m = np.zeros((64, 64), np.uint8)
    m[8:32, 8:32] = 1
    Image.fromarray(m).save(tv / "label" / "Bengal_9.png")
    cv2.imwrite(str(tv / "color" / "pug_77.jpg"), (rng.random((100, 120, 3)) * 255).astype(np.uint8))
    for stem in TEST:
        h, w = int(rng.integers(120, 260)), int(rng.integers(120, 260))
        img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        img[:, : w // 2] //= 2
        cv2.imwrite(str(te / "color" / f"{stem}.jpg"), img)
        m = np.zeros((h, w, 3), np.uint8)
        m[h // 4: h // 2, w // 4: w // 2] = 128
        m[:3, :] = 255
        Image.fromarray(m).save(te / "label" / f"{stem}.png")
    return root


def tree_bytes(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.fixture(scope="module")
def processed(tmp_path_factory):
    """The raw tree, and both packages' pipeline outputs and counts."""
    tmp = tmp_path_factory.mktemp("pipeline")
    raw = make_raw_archive(tmp / "raw")
    want = jax_pipeline.run_pipeline(raw, tmp / "jax", val_ratio=0.2, seed=3, verbose=False)
    got = pipeline.run_pipeline(raw, tmp / "port", val_ratio=0.2, seed=3, verbose=False)
    return {"raw": raw, "jax": tmp / "jax", "port": tmp / "port", "want": want, "got": got}


class TestPipeline:
    def test_matches_jax(self, processed):
        assert processed["got"] == processed["want"]
        assert processed["got"]["val"]["images"] == 2  # one cat, one dog
        port, jax = tree_bytes(processed["port"]), tree_bytes(processed["jax"])
        assert sorted(port) == sorted(jax)
        for name, data in port.items():
            assert data == jax[name], name
        stems = {p.stem for d in ("Train", "Val")
                 for p in (processed["port"] / d / "resized").glob("*.jpg")}
        assert stems == set(CATS + DOGS)  # the corrupt file and the mask-less one are out
        for stem in TEST:
            m = np.array(Image.open(processed["port"] / "Test" / "processed_labels"
                                    / f"{stem}.png"))
            assert m.ndim == 2 and m.shape != (512, 512)
            assert set(np.unique(m)) == {0, 1 if stem[0].isupper() else 2, 255}

    @pytest.mark.parametrize("seed", [0, 42])
    def test_stratified_split_matches_jax(self, processed, seed):
        _, tv, _ = pipeline.resolve_raw_layout(processed["raw"])
        assert pipeline.resolve_raw_layout(processed["raw"]) == \
            jax_pipeline.resolve_raw_layout(processed["raw"])
        imgs, masks = sorted((tv / "color").glob("*.jpg")), sorted((tv / "label").glob("*.png"))
        corrupt = {p.stem for p in imgs if pipeline.is_image_corrupt(p)}
        assert corrupt == {p.stem for p in imgs if jax_pipeline.is_image_corrupt(p)} == {
            "Bengal_9"}
        for ratio in (0.2, 0.5):
            assert (pipeline.stratified_split(imgs, masks, ratio, corrupt, seed)
                    == jax_pipeline.stratified_split(imgs, masks, ratio, corrupt, seed))
        for m in masks:
            assert pipeline.get_class_from_mask(m) == jax_pipeline.get_class_from_mask(m)
            assert np.array_equal(pipeline.load_mask(m), jax_pipeline.load_mask(m))

    @pytest.mark.parametrize("mask,name", [
        (np.array([[0, 128, 255], [128, 0, 0]], np.uint8), "persian_1.png"),
        (np.array([[0, 128, 255], [128, 0, 0]], np.uint8), "beagle_1.png"),
        (np.array([[0, 77, 255]], np.uint8), "siamese_2.png"),
        (np.pad(np.array([[[128]]], np.uint8), ((0, 1), (0, 1), (0, 2))), "sphynx_9.png"),
        (np.array([[0, 255], [255, 0]], np.uint8), "pug_1.png"),
        (np.random.default_rng(0).integers(0, 256, (64, 64)).astype(np.uint8), "bengal_1.png"),
        (np.full((4, 4), 9, np.uint8), "boxer_3.png"),
    ], ids=["128-cat", "128-dog", "other-value", "3d", "border-only", "random", "uniform"])
    def test_remap_raw_mask_matches_jax(self, mask, name):
        got = pipeline.remap_raw_mask(mask, name)
        assert got.dtype == mask.dtype
        assert np.array_equal(got, jax_pipeline.remap_raw_mask(mask, name))
        assert set(np.unique(got)) <= {0, 1, 2, 255}


def _reports(reports) -> list:
    return [dataclasses.asdict(r) for r in reports]


class TestTools:
    def test_sanity_checks_match_jax(self, processed, tmp_path):
        port = processed["port"]
        assert _reports(sanity_checks.run_sanity_checks(port)) == \
            _reports(jax_sanity.run_sanity_checks(port))
        assert all(r.passed for r in sanity_checks.run_sanity_checks(port, sample=2))
        # A tree with a missing mask, an image of another size and a bad value.
        broken = tmp_path / "broken"
        for split in ("Train", "Val"):
            (broken / split).mkdir(parents=True)
        for d in ("resized", "resized_label"):
            (broken / "Train" / d).symlink_to(port / "Train" / d)
        cv2.imwrite(str(tmp_path / "odd.jpg"), np.zeros((100, 80, 3), np.uint8))
        (broken / "Val" / "resized").mkdir()
        (broken / "Val" / "processed_labels").mkdir()
        cv2.imwrite(str(broken / "Val" / "resized" / "x.jpg"), np.zeros((100, 80, 3), np.uint8))
        Image.fromarray(np.full((8, 8), 7, np.uint8)).save(
            broken / "Val" / "processed_labels" / "y.png")
        got = sanity_checks.run_sanity_checks(broken)
        assert not all(r.passed for r in got)
        assert _reports(got) == _reports(jax_sanity.run_sanity_checks(broken))
        for args in ((tmp_path,), (broken / "Val" / "resized",)):
            assert (dataclasses.asdict(sanity_checks.check_resized_dimensions(*args))
                    == dataclasses.asdict(jax_sanity.check_resized_dimensions(*args)))
        mask = processed["raw"] / "Dataset_filtered" / "Test" / "label" / "boxer_1.png"
        assert sanity_checks.debug_mask_values(mask) == jax_sanity.debug_mask_values(mask)

    @pytest.mark.parametrize("split,max_files", [("Train", None), ("Val", 1), ("raw", None)])
    def test_analyze_dataset_matches_jax(self, processed, split, max_files):
        if split == "raw":
            base = processed["raw"] / "Dataset_filtered" / "TrainVal"
            dirs = (base / "color", base / "label")
        else:
            base = processed["port"] / split
            dirs = (base / "resized",
                    base / ("resized_label" if split == "Train" else "processed_labels"))
        got = dataset_analyzer.analyze_dataset(*dirs, max_files=max_files)
        want = jax_analyzer.analyze_dataset(*dirs, max_files=max_files)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.summary() == want.summary()
        if split == "raw":
            assert got.corrupt == ["Bengal_9.jpg"]

    def test_helpers_match_jax(self, tmp_path):
        for seed in (0, 42):
            helpers.seed_everything(seed)
            got = (random.random(), np.random.random())
            jax_helpers.seed_everything(seed)
            assert got == (random.random(), np.random.random())
        items = list(range(17))
        assert helpers.split_dataset(items, 0.3, 5) == jax_helpers.split_dataset(items, 0.3, 5)
        d = helpers.create_directory(tmp_path / "a" / "b")
        assert d.is_dir() and d == jax_helpers.create_directory(tmp_path / "a" / "b")
        (tmp_path / "s.txt").write_text("x")
        pairs = [(tmp_path / "s.txt", tmp_path / "c" / f"{i}.txt") for i in range(3)]
        assert helpers.copy_files(pairs) == 3
        assert (tmp_path / "c" / "2.txt").read_text() == "x"

    def test_extract_archive_matches_jax(self, processed, tmp_path):
        archive = tmp_path / "Data_filtered.tar"
        with tarfile.open(archive, "w") as tar:
            tar.add(processed["raw"] / "Dataset_filtered", arcname="Dataset_filtered")
        got = download.extract_archive(archive, tmp_path / "port")
        want = jax_download.extract_archive(archive, tmp_path / "jax")
        assert tree_bytes(got) == tree_bytes(want) == tree_bytes(processed["raw"])
        # ``cli download`` with the archive on disk extracts it, fetching nothing.
        cli.main(["download", "--raw_dir", str(tmp_path / "cli"), "--archive", str(archive)])
        assert tree_bytes(tmp_path / "cli") == tree_bytes(processed["raw"])


def test_cli_chain(processed, tmp_path):
    """``cli pipeline -> augment -> sanity_checks -> clip_resize`` on the raw
    tree, through the port's command line on the CPU."""
    data = tmp_path / "processed"
    stats = cli.main(["pipeline", "--raw_dir", str(processed["raw"]), "--processed_dir",
                      str(data), "--val_ratio", "0.2", "--seed", "3"])
    assert stats == processed["want"]
    aug = cli.main(["augment", "--data_dir", str(data), "--cat_augmentations", "1",
                    "--dog_augmentations", "1", "--device", "cpu"])
    n_train = len(list((data / "Train" / "resized").glob("*.jpg")))
    images = sorted((data / "Train" / "augmented" / "images").glob("*.jpg"))
    masks = sorted((data / "Train" / "augmented" / "masks").glob("*.png"))
    assert len(images) == len(masks) == n_train == aug["outputs"]
    reports = cli.main(["sanity_checks", "--data_dir", str(data)])
    names = [r.name for r in reports]
    assert all(r.passed for r in reports) and "augmented images <-> masks" in names
    counts = cli.main(["clip_resize", "--data_dir", str(data)])
    assert counts == {"Train": n_train, "Val": 2, "Test": len(TEST)}
    Image.fromarray(np.full((8, 8), 7, np.uint8)).save(
        data / "Train" / "augmented" / "masks" / "stray.png")
    with pytest.raises(SystemExit):
        cli.main(["sanity_checks", "--data_dir", str(data)])
