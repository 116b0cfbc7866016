"""The port's visualization suite and evaluate's figures against the JAX
package's ``utils/visualize.py`` and ``recipes/common.py``.

- The array functions (``denormalize_image``, ``colorize_mask``,
  ``error_analysis_map``, ``create_comparison_image``) equal JAX's bit for bit
  on inputs made from a seed with numpy.
- Every drawer writes a non-empty PNG (as ``tests/test_visualize.py``), the
  training curves from both CSV schemas.
- ``evaluate_segmentation`` with ``visualize_samples=2`` writes the first two
  batches' figures and the confusion matrix, runs the probability forward
  for those two batches only, and returns the results dict of
  ``visualize_samples=0`` (and of JAX's evaluate with figures).
- ``our_unet.evaluate``'s probabilities (``eval_fns``) against JAX's softmax
  of the full-width ``unet_6stage`` at 64² float32, weights carried by
  ``params_from_jax``, to rtol 1e-3 / atol 1e-4 (``tests/test_models.py``).
- Without matplotlib each evaluate with figures raises ``ImportError``
  before it loads its model, naming matplotlib and ``--visualize_samples 0``.
"""

import json
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_implementations_tpu.data.loader import PetDataset as JaxPetDataset
from unet_implementations_tpu.models.unet import unet_6stage as jax_unet_6stage
from unet_implementations_tpu.recipes import common as jax_common
from unet_implementations_tpu.utils import visualize as JV
from unet_implementations_tpu_torch.data.loader import PetDataset
from unet_implementations_tpu_torch.models import convert
from unet_implementations_tpu_torch.models.unet import unet_6stage
from unet_implementations_tpu_torch.recipes import ae_recon, clip_unet, common, our_unet
from unet_implementations_tpu_torch.utils import visualize as V


def _fake(seed=0, n=2, h=32, w=32):
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(n, h, w, 3)).astype(np.float32)
    masks = rng.integers(0, 3, (n, h, w)).astype(np.int32)
    masks[:, 0, :] = 255
    preds = rng.integers(0, 3, (n, h, w)).astype(np.int32)
    return images, masks, preds


class TestArrays:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_equal_to_jax(self, seed):
        images, masks, preds = _fake(seed, h=24, w=40)
        np.testing.assert_array_equal(V.CLASS_COLORS, JV.CLASS_COLORS)
        for i in range(len(images)):
            assert V.denormalize_image(images[i]).tobytes() == \
                JV.denormalize_image(images[i]).tobytes()
            for mask in (masks[i], preds[i]):
                assert V.colorize_mask(mask).tobytes() == JV.colorize_mask(mask).tobytes()
            got = V.error_analysis_map(preds[i], masks[i])
            assert got.dtype == np.uint8
            assert got.tobytes() == JV.error_analysis_map(preds[i], masks[i]).tobytes()
        rng = np.random.default_rng(seed + 10)
        original = rng.uniform(-0.1, 1.1, (24, 40, 3)).astype(np.float32)
        recon = np.clip(original + rng.normal(0, 0.05, original.shape), 0, 1).astype(np.float32)
        got = V.create_comparison_image(original, recon)
        assert got.shape == (24, 120, 3) and got.dtype == np.uint8
        assert got.tobytes() == JV.create_comparison_image(original, recon).tobytes()

    def test_error_map_codes(self):
        out = V.error_analysis_map(np.array([[1, 0, 2, 1, 0]]), np.array([[1, 1, 1, 0, 255]]))
        np.testing.assert_array_equal(out[0], [[0, 255, 0], [0, 0, 255], [255, 255, 0],
                                               [255, 0, 0], [0, 0, 0]])


class TestDrawers:
    def test_all_drawers_write_files(self, tmp_path):
        images, masks, preds = _fake()
        V.visualize_prediction_batch(images, masks, preds, tmp_path / "pred.png")
        probs = np.random.default_rng(1).random((32, 32, 3)).astype(np.float32)
        probs /= probs.sum(-1, keepdims=True)
        V.visualize_confidence_maps(images[0], probs, tmp_path / "conf.png")
        V.visualize_error_analysis(images[0], preds[0], masks[0], tmp_path / "err.png")
        cm = np.array([[50, 3, 2], [4, 30, 1], [2, 2, 40]], float)
        V.plot_confusion_matrix(cm, tmp_path / "cm.png")
        shares = V.plot_class_distribution(list(masks), tmp_path / "dist.png")
        assert shares == JV.plot_class_distribution(list(masks), tmp_path / "dist_jax.png")
        assert abs(sum(shares.values()) - 1.0) < 1e-6
        o = np.random.default_rng(2).random((2, 32, 32, 3)).astype(np.float32)
        V.save_comparison_grid(o, o * 0.9, tmp_path / "grid.png")
        for f in ("pred.png", "conf.png", "err.png", "cm.png", "dist.png", "grid.png"):
            assert (tmp_path / f).stat().st_size > 0

    def test_training_curves_both_schemas(self, tmp_path):
        seg = tmp_path / "seg.csv"
        seg.write_text(
            "epoch,train_loss,val_loss,dice_background,dice_cat,dice_dog,"
            "dice_mean_foreground,learning_rate,epoch_time\n"
            "1,2.0,1.5,0.5,0.3,0.4,0.35,0.005,100\n"
            "2,1.5,1.2,0.6,0.4,0.5,0.45,0.004,90\n")
        ae = tmp_path / "ae.csv"
        ae.write_text(
            "epoch,train_loss,val_loss,val_mse,val_psnr,learning_rate,epoch_time\n"
            "1,0.01,0.009,0.009,20.1,0.001,100\n")
        for csv_path in (seg, ae):
            V.plot_training_curves(csv_path, tmp_path / f"{csv_path.stem}.png")
            assert (tmp_path / f"{csv_path.stem}.png").stat().st_size > 0


def _write_test_split(root, sizes, seed):
    rng = np.random.default_rng(seed)
    images, masks = root / "Test" / "resized", root / "Test" / "processed_labels"
    images.mkdir(parents=True)
    masks.mkdir(parents=True)
    for i, (h, w) in enumerate(sizes):
        cv2.imwrite(str(images / f"test_{i}.jpg"),
                    rng.integers(0, 256, (h, w, 3)).astype(np.uint8))
        mask = np.zeros((h, w), np.uint8)
        mask[h // 4: 3 * h // 4, w // 4: 3 * w // 4] = 1 + i % 2
        mask[rng.random((h, w)) < 0.05] = 255
        cv2.imwrite(str(masks / f"test_{i}.png"), mask)
    return images, masks


def _fixed(batch):
    return ((batch["image"][..., 0] > 0).astype(np.int32)
            + (batch["mask"] == 2).astype(np.int32))


def test_evaluate_segmentation_figures(tmp_path):
    """Five images in batches of 2: batches 0 and 1 are drawn, batch 2 not;
    the results equal those without figures and JAX's with figures."""
    images, masks = _write_test_split(tmp_path / "data", [(40, 56), (64, 48), (33, 71),
                                                          (48, 48), (80, 20)], seed=1)
    dataset = PetDataset(images, masks, target_size=(48, 48))
    probs_calls = []

    def probs_fn(batch):
        probs_calls.append(len(batch["image"]))
        logits = torch.from_numpy(batch["image"]).float()
        return torch.softmax(logits, dim=-1)

    def predict_fn(batch):
        return torch.from_numpy(_fixed(batch))

    plain = common.evaluate_segmentation(predict_fn, dataset, batch_size=2,
                                         output_dir=tmp_path / "plain", verbose=False)
    drawn = common.evaluate_segmentation(predict_fn, dataset, batch_size=2,
                                         output_dir=tmp_path / "drawn", visualize_samples=2,
                                         probs_fn=probs_fn, verbose=False)
    assert drawn == plain
    assert probs_calls == [2, 2]
    assert not (tmp_path / "plain" / "visualizations").exists()
    viz = tmp_path / "drawn" / "visualizations"
    want = {f"{kind}_batch{i}.png" for kind in ("predictions", "error_analysis", "confidence")
            for i in (0, 1)} | {"confusion_matrix.png"}
    assert {p.name for p in viz.iterdir()} == want
    assert all((viz / name).stat().st_size > 0 for name in want)
    ref = jax_common.evaluate_segmentation(
        _fixed, JaxPetDataset(images, masks, target_size=(48, 48)), batch_size=2,
        output_dir=tmp_path / "ref", visualize_samples=2, verbose=False)
    assert drawn == ref
    assert json.loads((tmp_path / "drawn" / "evaluation_results.json").read_text()) == \
        json.loads((tmp_path / "ref" / "evaluation_results.json").read_text())
    assert {p.name for p in (tmp_path / "ref" / "visualizations").iterdir()} == \
        want - {"confidence_batch0.png", "confidence_batch1.png"}


def _seeded_params(tree, rng):
    out = {}
    for name, node in tree.items():
        if isinstance(node, dict):
            out[name] = _seeded_params(node, rng)
        elif name == "kernel":
            kh, kw, _, cout = node.shape
            out[name] = (rng.normal(size=node.shape) * np.sqrt(2.0 / (kh * kw * cout))).astype(
                np.float32)
        elif name == "scale":
            out[name] = (1.0 + 0.1 * rng.normal(size=node.shape)).astype(np.float32)
        else:
            out[name] = (0.1 * rng.normal(size=node.shape)).astype(np.float32)
    return out


def test_probs_fn_matches_jax_softmax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    jmodel = jax_unet_6stage(dtype=jnp.float32)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.asarray(x))["params"]
    params = _seeded_params(shapes, rng)
    want = np.asarray(jax.jit(lambda p, x: jax.nn.softmax(
        jmodel.apply({"params": p}, x, deterministic=True), axis=-1))(params, jnp.asarray(x)))
    model = unet_6stage(dtype=torch.float32, device="cpu").eval()
    model.load_state_dict(convert.params_from_jax(params, model), strict=True)
    predict_fn, probs_fn = our_unet.eval_fns(model, torch.float32)
    got = probs_fn({"image": x})
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(predict_fn({"image": x}).numpy(), got.argmax(-1).numpy())


@pytest.mark.parametrize("evaluate", [our_unet.evaluate, clip_unet.evaluate,
                                      ae_recon.evaluate], ids=["our_unet", "clip_unet",
                                                               "ae_recon"])
def test_figures_without_matplotlib_raise_before_loading(tmp_path, monkeypatch, evaluate):
    # No checkpoint at model_path: reaching the model load would raise
    # another error.
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib.*--visualize_samples 0"):
        evaluate(tmp_path / "none", tmp_path, tmp_path / "out", device="cpu",
                 visualize_samples=1)
    assert not (tmp_path / "out").exists()
