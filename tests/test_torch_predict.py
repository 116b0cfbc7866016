"""The port's serving path (unet_implementations_tpu_torch.recipes.common and
its ``predict`` command) on the CPU, against the JAX package where the two
share a function.

The factory is narrowed so that the 512² forward stays fast on the CPU.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_implementations_tpu.data.loader import IMAGENET_MEAN, IMAGENET_STD
from unet_implementations_tpu.models.unet import UNet as JaxUNet
from unet_implementations_tpu.recipes.common import resize_nearest_np as jax_resize_nearest_np
from unet_implementations_tpu_torch import cli
from unet_implementations_tpu_torch import default_device
from unet_implementations_tpu_torch.models import convert
from unet_implementations_tpu_torch.models.unet import UNet
from unet_implementations_tpu_torch.recipes import common

NARROW = (4, 8, 8, 8, 8, 8)
SIZES = [(375, 500), (120, 90), (512, 512)]


def _narrow_factory(dtype=torch.float32, device=None, generator=None):
    return UNet(features_per_stage=NARROW, dtype=dtype, generator=generator).to(
        default_device(device))


@pytest.fixture
def narrow_checkpoint(tmp_path, monkeypatch):
    monkeypatch.setattr(convert, "unet_6stage", _narrow_factory)
    path = tmp_path / "narrow.pth"
    convert.save_reference_checkpoint(
        _narrow_factory(device="cpu", generator=torch.Generator().manual_seed(4)), path)
    return path


@pytest.fixture
def image_dir(tmp_path):
    rng = np.random.default_rng(0)
    d = tmp_path / "images"
    d.mkdir()
    for i, (h, w) in enumerate(SIZES):
        cv2.imwrite(str(d / f"img{i}.jpg"), rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    (d / "notes.txt").write_text("not an image")
    return d


def _check_outputs(out_dir, overlay):
    for i, (h, w) in enumerate(SIZES):
        mask = cv2.imread(str(out_dir / f"img{i}_mask.png"), cv2.IMREAD_UNCHANGED)
        assert mask.shape == (h, w) and mask.dtype == np.uint8
        assert set(np.unique(mask)) <= {0, 1, 2}
        over = out_dir / f"img{i}_overlay.png"
        assert over.exists() == overlay
        if overlay:
            assert cv2.imread(str(over)).shape == (h, w, 3)


class TestPredictSegmentation:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
    def test_writes_masks_and_overlays(self, narrow_checkpoint, image_dir, tmp_path, dtype):
        out = tmp_path / "pred"
        n = common.predict_segmentation(narrow_checkpoint, image_dir, out, batch_size=2,
                                        dtype=dtype, device="cpu", verbose=False)
        assert n == len(SIZES)
        _check_outputs(out, overlay=True)

    def test_cli_predict(self, narrow_checkpoint, image_dir, tmp_path):
        out = tmp_path / "cli"
        cli.main(["predict", "--model_path", str(narrow_checkpoint), "--input",
                  str(image_dir), "--output_dir", str(out), "--batch_size", "4",
                  "--no_overlay", "--f32", "--device", "cpu"])
        _check_outputs(out, overlay=False)

    def test_no_silent_cpu(self, narrow_checkpoint, image_dir, tmp_path, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            common.predict_segmentation(narrow_checkpoint, image_dir, tmp_path / "x")
        assert not (tmp_path / "x").exists()


class TestPredictArrays:
    def test_matches_jax_argmax(self):
        """Masks from the port equal the JAX model's argmax, nearest-resized
        with the JAX package's resize, on the same weights (f32)."""
        config = dict(features_per_stage=NARROW)
        jmodel = JaxUNet(**config)
        rng = np.random.default_rng(1)
        images = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
        shapes = jax.eval_shape(jmodel.init, jax.random.key(2), jnp.zeros((1, 64, 64, 3)))
        params = jax.tree.map(  # Kaiming fan_out kernels, small non-zero vectors
            lambda s: (rng.normal(size=s.shape) * (
                np.sqrt(2.0 / (s.shape[0] * s.shape[1] * s.shape[3])) if len(s.shape) == 4
                else 0.1)).astype(np.float32), shapes["params"])
        model = UNet(**config).eval()
        model.load_state_dict(convert.params_from_jax(params, model), strict=True)
        dims = [(50, 70), (64, 64)]
        masks = common.predict_arrays(model, images, dims)

        x = (images.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
        logits = np.asarray(jax.jit(lambda p, x: jmodel.apply({"params": p}, x))(params, x))
        for mask, pred, d in zip(masks, logits.argmax(-1).astype(np.uint8), dims):
            want = jax_resize_nearest_np(pred, d)
            assert mask.shape == d
            assert (mask == want).mean() >= 0.99

    def test_resize_nearest_matches_jax(self):
        mask = np.random.default_rng(3).choice([0, 1, 2], (512, 512)).astype(np.uint8)
        for size in SIZES + [(17, 1023)]:
            np.testing.assert_array_equal(common.resize_nearest_np(mask, size),
                                          jax_resize_nearest_np(mask, size))

    def test_rejects_bad_input(self):
        model = UNet(features_per_stage=NARROW).eval()
        with pytest.raises(ValueError, match="uint8"):
            common.predict_arrays(model, np.zeros((1, 64, 64, 3), np.float32), [(64, 64)])
        with pytest.raises(ValueError, match="original sizes"):
            common.predict_arrays(model, np.zeros((2, 64, 64, 3), np.uint8), [(64, 64)])
