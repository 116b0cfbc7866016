"""The port's CLIP_UNet data path, recipe and CLI (unet_implementations_tpu_torch)
against the JAX package's, on the CPU.

- The loader's CLIP view on cv2-written files (a ``resized_clip/`` holding
  224² copies, one of another size, and files missing from it): every item
  equals JAX's bit for bit, uint8 and normalized; the decode cache with its
  ``clips.npy`` gives the direct items, and a cache built by either package
  opens in the other without a rebuild.
- ``resize_with_padding`` and ``create_clip_resized`` write JAX's bytes.
- The embedding tables, with a stand-in extractor: the table equals live
  extraction (to 1e-5 relative, the tolerance of ``tests/test_clip_recipe.py``
  for a per-batch against a whole-table pass), rows re-align by file name,
  a table of another encoder or a missing file is not used, and tables
  written by either package load in the other.
- One chain through the CLI on 2+2+2 images (float32, ``--clip_model
  ViT-B/32``, the smallest published tower; the UNet is the full-width
  ``unet_6stage`` with the fusion at 512²): ``clip_resize`` -> ``clip_unet
  embed`` -> ``clip_unet train --embeddings_dir`` (1 epoch) -> ``clip_unet
  evaluate`` with the tables, with live extraction and with
  ``--no_clip_features``. The artifacts have JAX's keys and headers; the
  tables and live extraction give every evaluation scalar within 2e-3;
  ``best_model/model.pth`` loads strictly, and into JAX's fusion UNet, whose
  float32 logits with features equal the port's to 1e-4 relative at 64².
  Then ``clip_unet train --online_augment``: live extraction once per
  training batch, no Train table.
- Every JAX ``clip_unet`` and ``clip_resize`` flag exists with JAX's
  defaults; the evaluates draw their figures at the default
  ``--visualize_samples 3`` (predictions and error maps, as JAX's).
"""

import csv
import json
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ae_recipe import _captured_config, _options
from test_torch_recipe import (SPLITS, DatasetsReached, reaches_config, stop_at_datasets,
                               write_split)
from unet_implementations_tpu.cli import build_parser as jax_build_parser
from unet_implementations_tpu.data import loader as jax_loader
from unet_implementations_tpu.data import pipeline as jax_pipeline
from unet_implementations_tpu.models import convert as jax_convert
from unet_implementations_tpu.models.unet import UNet as JaxUNet
from unet_implementations_tpu.recipes import clip_unet as jax_clip_unet
from unet_implementations_tpu_torch import cli
from unet_implementations_tpu_torch.data import loader, pipeline
from unet_implementations_tpu_torch.models.clip import ClipFeatureExtractor
from unet_implementations_tpu_torch.recipes import clip_unet
from unet_implementations_tpu_torch.training import checkpoint
from unet_implementations_tpu_torch.training.loop import SEG_CSV_HEADER

DEMO = Path(__file__).resolve().parents[1] / "demo" / "four_recipes" / "clip"
TARGET = (48, 48)
ORIGINALS = [(40, 56), (64, 48), (33, 71), (48, 48), (80, 20)]
FUSION_KEYS = [f"clip_fusion_conv.{i}.{p}" for i in (0, 1) for p in ("weight", "bias")]


def write_clip_dataset(root):
    """``root/resized`` jpgs, ``root/resized_label`` pngs and
    ``root/resized_clip``: padded 32² copies of images 0 and 1, a 20x24 copy
    of image 2 (resized again by the loader), none of 3 and 4 (the loader
    resizes their decode)."""
    rng = np.random.default_rng(0)
    images, masks, clips = root / "resized", root / "resized_label", root / "resized_clip"
    for d in (images, masks, clips):
        d.mkdir(parents=True)
    for i, (h, w) in enumerate(ORIGINALS):
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        cv2.imwrite(str(images / f"img_{i}.jpg"), img)
        cv2.imwrite(str(masks / f"img_{i}.png"),
                    rng.choice(np.array([0, 1, 2, 255], np.uint8), size=(h, w)))
        if i < 2:
            cv2.imwrite(str(clips / f"img_{i}.jpg"), jax_pipeline.resize_with_padding(img, 32))
        elif i == 2:
            cv2.imwrite(str(clips / f"img_{i}.jpg"), cv2.resize(img, (24, 20)))
    return images, masks, clips


def _pair(root, **kwargs):
    images, masks, clips = root / "resized", root / "resized_label", root / "resized_clip"
    args = dict(include_augmented=False, target_size=TARGET, clip_dir=clips, clip_size=32,
                **kwargs)
    return loader.PetDataset(images, masks, **args), jax_loader.PetDataset(images, masks, **args)


def _assert_items_equal(ours, ref):
    assert len(ours) == len(ref)
    for i in range(len(ref)):
        a, b = ours.load_item(i), ref.load_item(i)
        assert list(a) == list(b), (list(a), list(b))
        for k in b:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (i, k)


class TestLoaderClipView:
    @pytest.mark.parametrize("emit_uint8", [True, False])
    def test_items_equal_jax(self, tmp_path, emit_uint8, monkeypatch):
        monkeypatch.delenv("UNET_TPU_DECODE_CACHE", raising=False)
        write_clip_dataset(tmp_path)
        ours, ref = _pair(tmp_path, emit_uint8=emit_uint8)
        _assert_items_equal(ours, ref)
        item = ours.load_item(3)
        assert item["clip_image"].shape == (32, 32, 3)
        assert item["clip_image"].dtype == (np.uint8 if emit_uint8 else np.float32)

    def test_reconstruction_ignores_clip_dir(self, tmp_path, monkeypatch):
        monkeypatch.delenv("UNET_TPU_DECODE_CACHE", raising=False)
        write_clip_dataset(tmp_path)
        ours, ref = _pair(tmp_path, mode="reconstruction", emit_uint8=True)
        _assert_items_equal(ours, ref)
        assert "clip_image" not in ours.load_item(0)

    @pytest.mark.parametrize("builder", ["port", "jax"])
    def test_cache_shared_with_jax(self, tmp_path, builder, monkeypatch):
        monkeypatch.delenv("UNET_TPU_DECODE_CACHE", raising=False)
        write_clip_dataset(tmp_path)
        cache = tmp_path / "cache"
        direct, _ = _pair(tmp_path, emit_uint8=True)
        first, second = (loader, jax_loader) if builder == "port" else (jax_loader, loader)
        args = dict(include_augmented=False, target_size=TARGET, clip_size=32, emit_uint8=True,
                    clip_dir=tmp_path / "resized_clip", cache_dir=cache)
        built = first.PetDataset(tmp_path / "resized", tmp_path / "resized_label", **args)
        dirs = list(cache.iterdir())
        assert len(dirs) == 1 and (dirs[0] / "clips.npy").is_file()
        stamp = (dirs[0] / "manifest.json").stat().st_mtime_ns
        opened = second.PetDataset(tmp_path / "resized", tmp_path / "resized_label", **args)
        assert list(cache.iterdir()) == dirs
        assert (dirs[0] / "manifest.json").stat().st_mtime_ns == stamp  # not rebuilt
        ours = built if builder == "port" else opened
        assert ours.cache_path(cache) == dirs[0]
        _assert_items_equal(ours, direct)

    def test_cache_key_and_identity_carry_clip_size(self, tmp_path):
        images, masks, _ = write_clip_dataset(tmp_path)
        files = sorted(images.glob("*.jpg"))
        assert loader.cache_identity(files, TARGET, True, clip_size=32)["clip_size"] == 32
        assert loader.cache_path(tmp_path, images, masks, TARGET, clip_size=32) != \
            loader.cache_path(tmp_path, images, masks, TARGET)


class TestPipeline:
    @pytest.mark.parametrize("shape", [(40, 56, 3), (71, 33, 3), (48, 48, 3), (30, 50)])
    @pytest.mark.parametrize("nearest", [False, True])
    def test_resize_with_padding_equals_jax(self, shape, nearest):
        img = np.random.default_rng(sum(shape)).integers(0, 256, shape).astype(np.uint8)
        got = pipeline.resize_with_padding(img, 32, nearest=nearest)
        want = jax_pipeline.resize_with_padding(img, 32, nearest=nearest)
        assert got.dtype == want.dtype and np.array_equal(got, want)

    def test_create_clip_resized_equals_jax(self, tmp_path):
        images, _, _ = write_clip_dataset(tmp_path / "data")
        (images / "broken.jpg").write_bytes(b"not a jpeg")
        n = pipeline.create_clip_resized([images], tmp_path / "ours", 32)
        assert n == jax_pipeline.create_clip_resized([images], tmp_path / "ref", 32) == 5
        for f in sorted((tmp_path / "ref").iterdir()):
            assert (tmp_path / "ours" / f.name).read_bytes() == f.read_bytes(), f.name


class FakeExtractor:
    """A deterministic stand-in for the tower: per-image channel means."""

    output_dim = 8

    def __call__(self, clip_images):
        x = torch.as_tensor(np.asarray(clip_images), dtype=torch.float32)
        return x.mean(dim=(1, 2)).repeat(1, 3)[:, :self.output_dim]


class JaxFakeExtractor(FakeExtractor):
    def __call__(self, clip_images):
        x = jnp.asarray(clip_images, jnp.float32)
        return jnp.tile(jnp.mean(x, axis=(1, 2)), (1, 3))[:, :self.output_dim]


class TestEmbeddingTables:
    def _dataset(self, root, clip_size=32):
        return loader.PetDataset(root / "resized", root / "resized_label",
                                 include_augmented=False, target_size=TARGET,
                                 clip_dir=root / "resized_clip", clip_size=clip_size)

    def test_cached_equals_live(self, tmp_path, monkeypatch):
        monkeypatch.delenv("UNET_TPU_DECODE_CACHE", raising=False)
        write_clip_dataset(tmp_path)
        ds, ex = self._dataset(tmp_path), FakeExtractor()
        table = clip_unet._embedding_table(ex, ds, batch_size=3)
        assert table.shape == (5, 8) and table.dtype == np.float32
        live = list(loader.batch_iterator(ds, 2, shuffle=True, seed=3))
        cached = list(clip_unet._attach_features(
            loader.batch_iterator(ds, 2, shuffle=True, seed=3), table))
        assert len(cached) == len(live) == 3
        for a, b in zip(live, cached):
            np.testing.assert_array_equal(a["index"], b["index"])
            np.testing.assert_allclose(ex(a["clip_image"]).numpy(), b["clip_features"],
                                       rtol=1e-5, atol=1e-6)
            assert "clip_image" not in b
        item = ds.load_item(2)
        np.testing.assert_allclose(table[2], ex(item["clip_image"][None])[0].numpy(),
                                   rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("writer", ["port", "jax"])
    def test_tables_shared_with_jax(self, tmp_path, writer, monkeypatch):
        """Tables dumped by either package load row-aligned in the other; a
        table of another encoder, or a split without one, is not used."""
        monkeypatch.delenv("UNET_TPU_DECODE_CACHE", raising=False)
        for split in ("Train", "Val"):
            write_clip_dataset(tmp_path / split)
        monkeypatch.setattr(clip_unet, "ClipFeatureExtractor", lambda *a, **k: FakeExtractor())
        monkeypatch.setattr(jax_clip_unet, "ClipFeatureExtractor",
                            lambda *a, **k: JaxFakeExtractor())
        dump = clip_unet.dump_embeddings if writer == "port" else jax_clip_unet.dump_embeddings
        written = dump(tmp_path, tmp_path / "emb", clip_model="ViT-B/16",
                       splits=("Train", "Val", "Test"), verbose=False)
        assert set(written) == {"Train", "Val"}
        data = np.load(tmp_path / "emb" / "clip_embeddings_train.npz", allow_pickle=False)
        assert sorted(data.files) == ["embeddings", "files", "model"]
        assert str(data["model"]) == "ViT-B/16"

        # A dataset of the files in another order, with the dump's CLIP side
        # (224): rows follow the names.
        ds = self._dataset(tmp_path / "Train", clip_size=224)
        ds.image_files = ds.image_files[::-1]
        jds = jax_loader.PetDataset(tmp_path / "Train" / "resized", None,
                                    include_augmented=False, target_size=TARGET,
                                    clip_dir=tmp_path / "Train" / "resized_clip")
        jds.image_files = jds.image_files[::-1]
        for load, dset in ((clip_unet._load_embedding_table, ds),
                           (jax_clip_unet._load_embedding_table, jds)):
            table = load(tmp_path / "emb", "Train", dset, "ViT-B/16", verbose=False)
            expected = clip_unet._embedding_table(FakeExtractor(), ds, batch_size=2)
            np.testing.assert_allclose(table, expected, rtol=1e-5, atol=1e-6)
        assert clip_unet._load_embedding_table(tmp_path / "emb", "Train", ds, "ViT-L/14",
                                               verbose=False) is None
        assert clip_unet._load_embedding_table(tmp_path / "emb", "Test", ds, "ViT-B/16",
                                               verbose=False) is None
        ds.image_files = ds.image_files + [tmp_path / "Train" / "resized" / "other.jpg"]
        assert clip_unet._load_embedding_table(tmp_path / "emb", "Train", ds, "ViT-B/16",
                                               verbose=False) is None


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """clip_resize -> clip_unet embed -> train -> evaluate x3 through the CLI
    (float32, CPU, ViT-B/32)."""
    root = tmp_path_factory.mktemp("clip_chain")
    data, out = root / "data", root / "run"
    for split, seed in zip(SPLITS, (15, 16, 17)):
        write_split(data, split, [(64, 64), (64, 48)], seed)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("UNET_TPU_DECODE_CACHE", "")
        device = ["--device", "cpu", "--f32", "--clip_model", "ViT-B/32"]
        flags = ["--data_dir", str(data), *device, "--batch_size", "2", "--num_workers", "2",
                 "--decode_cache", str(root / "cache")]
        emb = str(data / "clip_embeddings")
        res = {"resize": cli.main(["clip_resize", "--data_dir", str(data)]),
               "embed": cli.main(["clip_unet", "embed", "--data_dir", str(data), *device,
                                  "--decode_cache", str(root / "cache")]),
               "train": cli.main(["clip_unet", "train", "--output_dir", str(out), "--epochs",
                                  "1", "--embeddings_dir", emb, *flags])}
        for name, extra in (("table", ["--embeddings_dir", emb]), ("live", []),
                            ("plain", ["--no_clip_features"])):
            res[name] = cli.main(["clip_unet", "evaluate", "--model_path",
                                  str(out / "best_model"), "--output_dir",
                                  str(out / f"eval_{name}"), *flags, *extra])
    return {"root": root, "data": data, "out": out, **res}


class TestChain:
    def test_clip_resize_and_tables(self, chain):
        data = chain["data"]
        assert chain["resize"] == {"Train": 2, "Val": 2, "Test": 2}
        for split in SPLITS:
            clips = sorted((data / split / "resized_clip").glob("*.jpg"))
            assert len(clips) == 2 and cv2.imread(str(clips[0])).shape == (224, 224, 3)
        assert set(chain["embed"]) == {"Train", "Val", "Test"}
        table = np.load(chain["embed"]["Test"], allow_pickle=False)
        assert table["embeddings"].shape == (2, 512) and str(table["model"]) == "ViT-B/32"
        assert list(table["files"]) == ["test_0.jpg", "test_1.jpg"]
        assert np.isfinite(table["embeddings"]).all() and table["embeddings"].any()

    def test_train_artifacts(self, chain, monkeypatch, tmp_path):
        out = chain["out"]
        assert chain["train"]["epochs_run"] == 1 and chain["train"]["step"] == 1
        config = json.loads((out / "training_config.json").read_text())
        assert list(config) == _captured_config(monkeypatch, jax_clip_unet, tmp_path)
        assert list(config) == list(json.loads((DEMO / "training_config.json").read_text()))
        assert config["clip_model"] == "ViT-B/32" and config["batch_size"] == 2
        with open(out / "training_log.csv") as f:
            rows = list(csv.reader(f))
        assert ",".join(rows[0]) == SEG_CSV_HEADER == \
            (DEMO / "training_log.csv").read_text().splitlines()[0]
        assert len(rows) == 2 and rows[1][7] == "0.0050000"
        assert np.isfinite([float(v) for v in rows[1][1:7]]).all()
        for d in (out / "checkpoints" / "epoch_1", out / "best_model"):
            meta = json.loads((d / "meta.json").read_text())
            assert meta["config"] == clip_unet.ARCH_CONFIG == jax_clip_unet.ARCH_CONFIG
            assert meta["config"]["with_clip_features"] is True
            assert meta["config"]["clip_dim"] == 512

    def test_evaluations(self, chain):
        demo = list(json.loads((DEMO / "evaluation_results.json").read_text()))
        for name in ("table", "live", "plain"):
            written = json.loads((chain["out"] / f"eval_{name}" /
                                  "evaluation_results.json").read_text())
            assert list(written) == demo and written == chain[name]

        def scalars(r):
            return [r["pixel_accuracy"], r["mean_iou"], r["mean_foreground_dice"]] + [
                r[c][k] for c in ("background", "cat", "dog")
                for k in ("dice", "iou", "precision", "recall")]

        for a, b in zip(scalars(chain["table"]), scalars(chain["live"])):
            assert abs(a - b) <= 2e-3 or (np.isnan(a) and np.isnan(b)), (a, b)

    def test_best_model_loads_into_jax(self, chain):
        path = chain["out"] / "best_model" / "model.pth"
        sd = checkpoint.load_checkpoint(path)["model_state_dict"]
        assert set(FUSION_KEYS) <= set(sd)
        model = clip_unet.build_model(torch.float32, "cpu")
        model.load_state_dict(sd, strict=True)
        model.eval()
        jmodel = JaxUNet(clip_fusion=True, dtype=jnp.float32)
        params = jax_convert.load_torch_checkpoint(path, jmodel)
        rng = np.random.default_rng(9)
        x = rng.random((1, 64, 64, 3)).astype(np.float32)
        cf = rng.normal(size=(1, 512)).astype(np.float32)
        want = np.asarray(jax.jit(lambda p, v, c: jmodel.apply({"params": p}, v, c))(
            params, jnp.asarray(x), jnp.asarray(cf)))
        with torch.no_grad():
            got = model(torch.from_numpy(x), torch.from_numpy(cf)).numpy()
        assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-4


def test_train_online_augment_extracts_live(chain, tmp_path, monkeypatch):
    """``clip_unet train --online_augment --embeddings_dir``: the tower runs
    once per training batch on its augmented 224² view, no Train table is
    read or computed, and validation reads its table."""
    tables, computed, seen = [], [], []
    load = clip_unet._load_embedding_table

    def load_table(embeddings_dir, split, *args, **kwargs):
        tables.append(split)
        return load(embeddings_dir, split, *args, **kwargs)

    call = ClipFeatureExtractor.__call__

    def extract(self, images):
        seen.append((tuple(images.shape), images.dtype))
        return call(self, images)

    monkeypatch.setattr(clip_unet, "_load_embedding_table", load_table)
    monkeypatch.setattr(clip_unet, "_embedding_table", lambda *a, **k: computed.append(a))
    monkeypatch.setattr(ClipFeatureExtractor, "__call__", extract)
    monkeypatch.setenv("UNET_TPU_DECODE_CACHE", "")
    out = tmp_path / "run"
    result = cli.main(["clip_unet", "train", "--online_augment", "--output_dir", str(out),
                       "--data_dir", str(chain["data"]), "--embeddings_dir",
                       str(chain["data"] / "clip_embeddings"), "--device", "cpu", "--f32",
                       "--clip_model", "ViT-B/32", "--batch_size", "2", "--epochs", "1",
                       "--num_workers", "2"])
    assert result["step"] == 1
    assert tables == ["Val"] and computed == []
    assert seen == [((2, 224, 224, 3), torch.float32)]
    config = json.loads((out / "training_config.json").read_text())
    assert config["online_augment"] is True
    with open(out / "training_log.csv") as f:
        rows = list(csv.reader(f))
    assert len(rows) == 2 and np.isfinite([float(v) for v in rows[1][1:7]]).all()


class TestCli:
    def test_every_jax_flag_exists(self):
        ours, ref = _options(cli.build_parser(), "clip_unet"), _options(jax_build_parser(),
                                                                       "clip_unet")
        assert ours.keys() == ref.keys() == {"train", "evaluate", "embed"}
        for cmd in ref:
            assert ref[cmd] <= ours[cmd], ref[cmd] - ours[cmd]

    @pytest.mark.parametrize("argv,want", [
        (["clip_unet", "train", "--data_dir", "d", "--output_dir", "o"],
         dict(batch_size=16, clip_model="ViT-B/16", clip_weights=None, embeddings_dir=None,
              use_clip=False, lr=5e-3, momentum=0.99, epochs=100)),
        (["clip_unet", "train", "--data_dir", "d", "--output_dir", "o", "--use_clip",
          "--clip_model", "ViT-L/14"], dict(use_clip=True, clip_model="ViT-L/14")),
        (["clip_unet", "evaluate", "--model_path", "m", "--data_dir", "d",
          "--no_clip_features", "--embeddings_dir", "e"],
         dict(no_clip_features=True, embeddings_dir="e", batch_size=32,
              output_dir="evaluation_results")),
        (["clip_unet", "embed", "--data_dir", "d", "--no_augmented"],
         dict(output_dir=None, batch_size=64, no_augmented=True, clip_model="ViT-B/16")),
        (["clip_resize", "--data_dir", "d"], dict(data_dir="d", size=224)),
    ])
    def test_jax_argv_parses(self, argv, want):
        args = cli.build_parser().parse_args(argv)
        assert {k: getattr(args, k) for k in want} == want
        ref = jax_build_parser().parse_args(argv)
        assert {k: getattr(ref, k) for k in want} == want

    @pytest.mark.parametrize("argv,error,match", [
        (["--grad_accum", "2"], None, "grad_accum"),
        (["--grad_accum", "3"], ValueError, "does not divide"),
    ])
    def test_train_flags_not_ported_raise(self, tmp_path, monkeypatch, argv, error, match):
        argv = ["clip_unet", "train", *argv, "--data_dir", str(tmp_path / "none"),
                "--output_dir", str(tmp_path / "o"), "--device", "cpu"]
        if error is None:  # ported: the value reaches the recipe and its config
            assert reaches_config(monkeypatch, clip_unet, argv, tmp_path / "o")[match] == 2
            return
        with pytest.raises(error, match=match):
            cli.main(argv)
        assert not (tmp_path / "o").exists()

    def test_not_ported_raise(self, chain, tmp_path, monkeypatch):
        # use_mesh=True is ported: one process (no process group) trains as
        # without it, so the call gets as far as its datasets.
        monkeypatch.setattr(clip_unet, "make_datasets", stop_at_datasets)
        with pytest.raises(DatasetsReached):
            clip_unet.train(tmp_path, tmp_path / "o", use_mesh=True, device="cpu")
        assert json.loads((tmp_path / "o" / "training_config.json").read_text())[
            "with_clip_features"] is True
        # Ported: each evaluate of the chain drew its one batch at the CLI's
        # default --visualize_samples 3, predictions only as JAX's (no
        # confidence maps).
        for name in ("table", "live", "plain"):
            viz = chain["out"] / f"eval_{name}" / "visualizations"
            assert sorted(p.name for p in viz.iterdir()) == [
                "confusion_matrix.png", "error_analysis_batch0.png", "predictions_batch0.png"]

    @pytest.mark.parametrize("argv", [
        ["clip_unet", "train", "--output_dir", "o"], ["clip_unet", "embed"]])
    def test_no_card_raises(self, tmp_path, monkeypatch, argv):
        """Without ``--device`` the commands run on CUDA, and say so when
        there is no card; they do not fall back to the CPU."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main([*argv, "--data_dir", str(tmp_path)])
