"""The port's ``our_unet`` recipe and CLI (unet_implementations_tpu_torch)
against the JAX package's.

- ``evaluate_segmentation`` with a fixed ``predict_fn`` gives exactly the
  results dict of JAX's, on a dataset of originals of several sizes.
- One run of ``cli our_unet train --device cpu --f32 --batch_size 2
  --epochs 1`` and ``cli our_unet evaluate`` on a dataset of 64² originals
  (the model is the full-width ``unet_6stage`` at 512²): the artifacts have
  the keys and header of JAX's (``training_config.json`` those of JAX's
  ``train()``, the CSV header and ``evaluation_results.json`` those in
  ``demo/four_recipes/our_unet/``); ``best_model/model.pth`` loads into the
  JAX package through ``convert.load_torch_checkpoint`` and gives the port's
  float32 logits to 1e-4 relative at 64²; ``evaluate`` of the ``.pth`` file
  gives what ``evaluate`` of the directory gives.
- ``our_unet train --online_augment`` on the CPU: one augmentation per
  training batch, ``Train/augmented/`` not read.
- The argv lists of ``tests/test_cli.py``'s ``our_unet`` cases parse, every
  JAX ``our_unet`` flag exists, and the flags that are not ported raise.
"""

import csv
import json
import shutil
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_implementations_tpu.cli import build_parser as jax_build_parser
from unet_implementations_tpu.data.loader import PetDataset as JaxPetDataset
from unet_implementations_tpu.models import convert as jax_convert
from unet_implementations_tpu.models.unet import unet_6stage as jax_unet_6stage
from unet_implementations_tpu.recipes import common as jax_common
from unet_implementations_tpu.recipes import our_unet as jax_our_unet
from unet_implementations_tpu_torch import cli
from unet_implementations_tpu_torch.data.loader import PetDataset
from unet_implementations_tpu_torch.models.unet import UNet
from unet_implementations_tpu_torch.recipes import common, our_unet
from unet_implementations_tpu_torch.training import checkpoint

REPO = Path(__file__).resolve().parents[1]
DEMO = REPO / "demo" / "four_recipes" / "our_unet"
SPLITS = {"Train": "resized_label", "Val": "processed_labels", "Test": "processed_labels"}


def write_split(root, split, originals, seed):
    rng = np.random.default_rng(seed)
    images, masks = root / split / "resized", root / split / SPLITS[split]
    images.mkdir(parents=True)
    masks.mkdir(parents=True)
    for i, (h, w) in enumerate(originals):
        cv2.imwrite(str(images / f"{split.lower()}_{i}.jpg"),
                    rng.integers(0, 256, (h, w, 3)).astype(np.uint8))
        mask = np.zeros((h, w), np.uint8)
        mask[h // 4: 3 * h // 4, w // 4: 3 * w // 4] = 1 + i % 2
        mask[rng.random((h, w)) < 0.05] = 255
        cv2.imwrite(str(masks / f"{split.lower()}_{i}.png"), mask)
    return images, masks


def test_evaluate_segmentation_equals_jax(tmp_path):
    images, masks = write_split(tmp_path, "Test", [(40, 56), (64, 48), (33, 71), (48, 48),
                                                   (80, 20)], seed=1)

    def fixed(batch):
        return ((batch["image"][..., 0] > 0).astype(np.int32)
                + (batch["mask"] == 2).astype(np.int32))

    ours = common.evaluate_segmentation(
        lambda b: torch.from_numpy(fixed(b)), PetDataset(images, masks, target_size=(48, 48)),
        batch_size=2, output_dir=tmp_path / "ours", verbose=False)
    ref = jax_common.evaluate_segmentation(
        fixed, JaxPetDataset(images, masks, target_size=(48, 48)), batch_size=2,
        output_dir=tmp_path / "ref", verbose=False)
    assert ours == ref
    assert json.loads((tmp_path / "ours" / "evaluation_results.json").read_text()) == \
        json.loads((tmp_path / "ref" / "evaluation_results.json").read_text())


@pytest.fixture(scope="module")
def recipe_run(tmp_path_factory):
    """One train (1 epoch, b2, float32, CPU) and evaluate through the CLI."""
    root = tmp_path_factory.mktemp("recipe")
    data, out = root / "data", root / "run"
    for split, seed in zip(SPLITS, (2, 3, 4)):
        write_split(data, split, [(64, 64), (64, 48)], seed)
    with pytest.MonkeyPatch.context() as mp:
        # cli sets UNET_TPU_DECODE_CACHE for the process; put it back after.
        mp.setenv("UNET_TPU_DECODE_CACHE", "")
        common_flags = ["--data_dir", str(data), "--device", "cpu", "--f32",
                        "--batch_size", "2", "--num_workers", "2",
                        "--decode_cache", str(root / "cache")]
        result = cli.main(["our_unet", "train", "--output_dir", str(out), "--epochs", "1",
                           *common_flags])
        results = cli.main(["our_unet", "evaluate", "--model_path", str(out / "best_model"),
                            "--output_dir", str(out / "eval"), *common_flags])
        from_file = cli.main(["our_unet", "evaluate", "--model_path",
                              str(out / "best_model" / "model.pth"),
                              "--output_dir", str(out / "eval_pth"), *common_flags])
    return {"root": root, "out": out, "result": result, "results": results,
            "from_file": from_file}


class TestRecipe:
    def test_artifacts(self, recipe_run):
        out = recipe_run["out"]
        assert recipe_run["result"]["epochs_run"] == 1 and recipe_run["result"]["step"] == 1
        for d in (out / "checkpoints" / "epoch_1", out / "best_model"):
            assert (d / "model.pth").is_file() and (d / "meta.json").is_file()
        with open(out / "training_log.csv") as f:
            rows = list(csv.reader(f))
        assert rows[0] == (DEMO / "training_log.csv").read_text().splitlines()[0].split(",")
        assert len(rows) == 2 and rows[1][0] == "1" and rows[1][7] == "0.0050000"
        assert np.isfinite([float(v) for v in rows[1][1:7]]).all()
        assert sorted(p.name.split("_")[0] for p in (recipe_run["root"] / "cache").iterdir()) \
            == ["Test", "Train", "Val"]

    def test_training_config_keys_equal_jax(self, recipe_run, monkeypatch, tmp_path):
        captured = {}

        class Written(Exception):
            pass

        def capture(output_dir, config):
            captured.update(config)
            raise Written

        monkeypatch.setattr(jax_our_unet, "write_training_config", capture)
        with pytest.raises(Written):
            jax_our_unet.train(tmp_path / "d", tmp_path / "o", use_mesh=False)
        ours = json.loads((recipe_run["out"] / "training_config.json").read_text())
        assert list(ours) == list(captured)
        assert list(ours) == list(json.loads((DEMO / "training_config.json").read_text()))
        assert ours["dtype"] == "torch.float32" and ours["batch_size"] == 2

    def test_evaluation_results_schema(self, recipe_run):
        demo = json.loads((DEMO / "evaluation_results.json").read_text())
        written = json.loads((recipe_run["out"] / "eval" / "evaluation_results.json").read_text())
        assert list(written) == list(demo)
        for key, value in demo.items():
            if isinstance(value, dict):
                assert list(written[key]) == list(value)
        assert written == recipe_run["results"]
        # The reference .pth file evaluates as its checkpoint directory does.
        assert recipe_run["from_file"] == recipe_run["results"]

    def test_best_model_loads_into_jax(self, recipe_run):
        path = recipe_run["out"] / "best_model" / "model.pth"
        jmodel = jax_unet_6stage(dtype=jnp.float32)
        params = jax_convert.load_torch_checkpoint(path, jmodel)
        x = np.random.default_rng(5).normal(size=(1, 64, 64, 3)).astype(np.float32)
        forward = jax.jit(lambda p, v: jmodel.apply({"params": p}, v, deterministic=True))
        want = np.asarray(forward(params, jnp.asarray(x)))
        model = checkpoint.restore_params(path.parent, UNet(dtype=torch.float32)).eval()
        with torch.no_grad():
            got = model(torch.from_numpy(x)).numpy()
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= 1e-4, rel
        meta = json.loads((path.parent / "meta.json").read_text())
        assert list(meta) == ["epoch", "best_metric", "config", "early_stopping"]
        assert meta["config"] == our_unet.ARCH_CONFIG == jax_our_unet.ARCH_CONFIG


class DatasetsReached(Exception):
    pass


def stop_at_datasets(*args, **kwargs):
    raise DatasetsReached


def reaches_config(monkeypatch, module, argv, output_dir) -> dict:
    """Run ``cli.main(argv)`` up to the recipe's ``make_datasets`` (which
    raises here) and return the ``training_config.json`` the recipe wrote
    from the values it was given."""
    monkeypatch.setattr(module, "make_datasets", stop_at_datasets)
    with pytest.raises(DatasetsReached):
        cli.main(argv)
    return json.loads((output_dir / "training_config.json").read_text())


def count_calls(monkeypatch, module, name):
    """Count the calls of ``module.name`` (still calling it)."""
    calls = []
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        calls.append(args)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)
    return calls


def test_online_augment_trains(recipe_run, tmp_path, monkeypatch):
    """``our_unet train --online_augment``: each training batch is augmented
    on the device (one call per batch), ``Train/augmented/`` is not read (two
    files there would make a second batch), and the config records the
    flag."""
    data = tmp_path / "data"
    shutil.copytree(recipe_run["root"] / "data", data)
    for sub in ("images", "masks"):
        (data / "Train" / "augmented" / sub).mkdir(parents=True)
    for i in range(2):
        shutil.copy(data / "Train" / "resized" / f"train_{i}.jpg",
                    data / "Train" / "augmented" / "images" / f"train_{i}_aug0.jpg")
        shutil.copy(data / "Train" / "resized_label" / f"train_{i}.png",
                    data / "Train" / "augmented" / "masks" / f"train_{i}_aug0.png")
    calls = count_calls(monkeypatch, common, "augment_and_normalize")
    monkeypatch.setenv("UNET_TPU_DECODE_CACHE", "")
    out = tmp_path / "run"
    result = cli.main(["our_unet", "train", "--online_augment", "--data_dir", str(data),
                       "--output_dir", str(out), "--device", "cpu", "--f32", "--batch_size",
                       "2", "--epochs", "1", "--num_workers", "2"])
    assert result["step"] == 1 and len(calls) == 1
    assert json.loads((out / "training_config.json").read_text())["online_augment"] is True
    with open(out / "training_log.csv") as f:
        rows = list(csv.reader(f))
    assert len(rows) == 2 and np.isfinite([float(v) for v in rows[1][1:7]]).all()
    assert (out / "best_model" / "model.pth").is_file()


def _options(parser, *path):
    for name in path:
        action = next(a for a in parser._actions if a.dest in ("recipe", "command"))
        parser = action.choices[name]
        if name == "our_unet":
            parser = next(a for a in parser._actions if a.dest == "cmd").choices
            return {cmd: {s for a in p._actions for s in a.option_strings}
                    for cmd, p in parser.items()}
    raise AssertionError(path)


class TestCli:
    def test_every_jax_flag_exists(self):
        ours = _options(cli.build_parser(), "our_unet")
        ref = _options(jax_build_parser(), "our_unet")
        assert ours.keys() == ref.keys() == {"train", "evaluate"}
        for cmd in ref:
            assert ref[cmd] <= ours[cmd], ref[cmd] - ours[cmd]

    @pytest.mark.parametrize("argv,want", [
        (["our_unet", "train", "--data_dir", "d", "--output_dir", "o"],
         dict(batch_size=32, lr=5e-3, momentum=0.99, weighted_ce=True, patience=15,
              epochs=100, save_every=10, device=None)),
        (["our_unet", "train", "--data_dir", "d", "--output_dir", "o", "--batch_size", "8"],
         dict(batch_size=8)),
        (["our_unet", "train", "--data_dir", "d", "--output_dir", "o", "--num_workers", "4",
          "--device", "cuda", "--amp", "--reduced_complexity", "--no_mesh",
          "--no-weighted_ce"],
         dict(num_workers=4, device="cuda", amp=True, reduced_complexity=True,
              no_mesh=True, weighted_ce=False)),
        (["our_unet", "evaluate", "--model_path", "m", "--data_dir", "d",
          "--num_workers", "2", "--device", "cpu"],
         dict(num_workers=2, device="cpu", visualize_samples=0,
              output_dir="evaluation_results", batch_size=32)),
    ])
    def test_jax_argv_parses(self, argv, want):
        args = cli.build_parser().parse_args(argv)
        assert {k: getattr(args, k) for k in want} == want
        assert not hasattr(args, "features_per_stage")

    def test_num_workers_alias(self):
        parse = cli.build_parser().parse_args
        base = ["our_unet", "train", "--data_dir", "d", "--output_dir", "o"]
        assert cli._num_threads(parse(base + ["--num_workers", "3"])) == 3
        assert cli._num_threads(parse(base + ["--num_workers", "0", "--num_threads", "5"])) == 5
        assert cli._num_threads(parse(["our_unet", "evaluate", "--model_path", "m",
                                       "--data_dir", "d"])) == 8

    @pytest.mark.parametrize("flags,error,item", [
        (["--spatial", "2"], ValueError, "needs a process group"),
        (["--grad_accum", "2"], None, "grad_accum"),
        (["--grad_accum", "3"], ValueError, "does not divide"),
        (["--grad_accum", "0"], ValueError, ">= 1"),
    ])
    def test_train_flags_not_ported_raise(self, tmp_path, monkeypatch, flags, error, item):
        argv = ["our_unet", "train", "--data_dir", str(tmp_path / "none"),
                "--output_dir", str(tmp_path / "o"), "--device", "cpu", *flags]
        if error is None:  # ported: the value reaches the recipe and its config
            assert reaches_config(monkeypatch, our_unet, argv, tmp_path / "o")[item] == \
                int(flags[1])
            return
        with pytest.raises(error, match=item):
            cli.main(argv)
        assert not (tmp_path / "o").exists()

    def test_visualize_samples_raises(self, tmp_path):
        with pytest.raises(NotImplementedError, match="item 8"):
            cli.main(["our_unet", "evaluate", "--model_path", str(tmp_path / "m"),
                      "--data_dir", str(tmp_path), "--device", "cpu",
                      "--visualize_samples", "1"])

    def test_no_card_raises(self, tmp_path, monkeypatch):
        """Without ``--device`` the recipe runs on CUDA, and says so when
        there is no card; it does not fall back to the CPU."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["our_unet", "train", "--data_dir", str(tmp_path),
                      "--output_dir", str(tmp_path / "o")])
