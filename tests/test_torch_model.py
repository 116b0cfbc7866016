"""The port's UNet, ops and converters (unet_implementations_tpu_torch) against JAX.

The JAX ``UNet`` is built with its default flags (which include the exact
space-to-depth paths); its weights cross to the port with
``params_from_jax``, and both forwards see the same numpy input.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_implementations_tpu.data.loader import IMAGENET_MEAN as JAX_MEAN
from unet_implementations_tpu.data.loader import IMAGENET_STD as JAX_STD
from unet_implementations_tpu.models.convert import params_to_torch_unet_state_dict
from unet_implementations_tpu.models.unet import UNet as JaxUNet
from unet_implementations_tpu.models.unet import unet_6stage as jax_unet_6stage
from unet_implementations_tpu.ops.normalize import normalize_image as jax_normalize
from unet_implementations_tpu.ops.resize import resize_bilinear as jax_resize_bilinear
from unet_implementations_tpu.utils.visualize import colorize_mask as jax_colorize
from unet_implementations_tpu_torch import default_device
from unet_implementations_tpu_torch.models import convert
from unet_implementations_tpu_torch.models.unet import S2D_LAYOUT as S2D
from unet_implementations_tpu_torch.models.unet import UNet, unet_6stage
from unet_implementations_tpu_torch.ops import normalize as torch_normalize
from unet_implementations_tpu_torch.ops.resize import resize_bilinear
from unet_implementations_tpu_torch.utils.visualize import colorize_mask

REPO = Path(__file__).resolve().parents[1]

TINY = dict(features_per_stage=(4, 8, 8), strides=(1, 2, 2),
            encoder_dropout_rates=(0.0, 0.0, 0.0), decoder_dropout_rates=(0.0, 0.0))
# Six stages at narrow widths with the default dropout schedule (key steps 3
# and 4). 32 channels at stage 1 makes the JAX model run decoder_3 in s2d.
NARROW6 = dict(features_per_stage=(8, 32, 16, 16, 16, 16))


def _seeded_params(tree, rng):
    """Values for the JAX params tree from numpy: Kaiming fan_out conv
    kernels, and non-trivial biases and norm affines (the JAX init's zero
    biases and unit scales would leave those mappings untested)."""
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


def _jax_and_port(config, size, seed, **layout):
    jmodel = JaxUNet(**config)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.asarray(x))["params"]
    params = _seeded_params(shapes, rng)
    model = UNet(**config, **layout).eval()
    model.load_state_dict(convert.params_from_jax(params, model), strict=True)
    return jmodel, params, model, x


class TestForwardParity:
    @pytest.mark.parametrize("config,size", [(TINY, 16), (TINY, 18), (NARROW6, 64)],
                             ids=["tiny3-16", "tiny3-18-odd", "narrow6-64"])
    def test_matches_jax(self, config, size):
        jmodel, params, model, x = _jax_and_port(config, size, seed=size)
        forward = jax.jit(lambda p, x: jmodel.apply({"params": p}, x))
        want = np.asarray(forward(params, jnp.asarray(x)))
        with torch.no_grad():
            got = model(torch.from_numpy(x))
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-4)


class TestS2dLayout:
    """The port's space-to-depth UNet (NARROW6 at 64², f32, eval: level 0 and
    decoder_3 in s2d, three fused tails) against the JAX default UNet, with
    JAX's fused tail on (``jnp_tail`` on the CPU) and off (its module path),
    to rtol 1e-3 / atol 1e-4; and against the port's own dense forward on the
    same weights (float32, 1e-5 relative L2: an exact rewrite, only sum
    orders differ)."""

    @pytest.mark.parametrize("region", ["1", "0"])
    def test_matches_jax(self, region, monkeypatch):
        monkeypatch.setenv("UNET_TPU_S2D_REGION", region)
        jmodel, params, model, x = _jax_and_port(NARROW6, 64, seed=7, **S2D)
        want = np.asarray(jax.jit(lambda p, x: jmodel.apply({"params": p}, x))(
            params, jnp.asarray(x)))
        with torch.no_grad():
            got = model(torch.from_numpy(x))
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-4)

    @pytest.mark.parametrize("size", [64, 34], ids=["even", "odd-half"])
    def test_matches_dense(self, size):
        dense = UNet(**NARROW6, generator=torch.Generator().manual_seed(4)).eval()
        s2d = UNet(**NARROW6, **S2D).eval()
        s2d.load_state_dict(dense.state_dict(), strict=True)
        x = torch.from_numpy(np.random.default_rng(size).normal(size=(2, size, size, 3)).astype(
            np.float32))
        with torch.no_grad():
            want, got = dense(x), s2d(x)
        assert float((got - want).norm() / want.norm()) <= 1e-5

    def test_train_mode_module_path(self):
        """Training mode takes the module path (no fused tail): with dropout
        rates 0 it equals the dense model in training mode."""
        config = dict(features_per_stage=(8, 32, 16), strides=(1, 2, 2),
                      encoder_dropout_rates=(0.0,) * 3, decoder_dropout_rates=(0.0,) * 2)
        dense = UNet(**config, generator=torch.Generator().manual_seed(6)).train()
        s2d = UNet(**config, **S2D).train()
        s2d.load_state_dict(dense.state_dict(), strict=True)
        x = torch.from_numpy(np.random.default_rng(6).normal(size=(2, 32, 32, 3)).astype(
            np.float32))
        with torch.no_grad():
            want, got = dense(x), s2d(x)
        assert float((got - want).norm() / want.norm()) <= 1e-5

    def test_same_state_dict_keys(self):
        dense, s2d = unet_6stage(device="cpu"), unet_6stage(device="cpu", **S2D)
        assert list(dense.state_dict()) == list(s2d.state_dict())
        assert [v.shape for v in dense.state_dict().values()] == \
            [v.shape for v in s2d.state_dict().values()]

    def test_one_checkpoint_loads_both_layouts(self, tmp_path):
        model = unet_6stage(device="cpu", generator=torch.Generator().manual_seed(8))
        path = tmp_path / "model.pth"
        convert.save_reference_checkpoint(model, path)
        loaded = convert.load_reference_checkpoint(path, device="cpu", dtype=torch.float32, **S2D)
        assert loaded.s2d_level0 and loaded.s2d_low_channel_decoders and not loaded.training
        for (k, a), b in zip(model.state_dict().items(), loaded.state_dict().values()):
            assert torch.equal(a, b), k
        x = torch.from_numpy(np.random.default_rng(8).normal(size=(1, 64, 64, 3)).astype(
            np.float32))
        with torch.no_grad():
            want, got = model.eval()(x), loaded(x)
        assert float((got - want).norm() / want.norm()) <= 1e-5


class TestConvert:
    @pytest.mark.parametrize("config", [TINY, NARROW6], ids=["tiny3", "narrow6"])
    def test_params_from_jax_equals_reference_export(self, config):
        jmodel, params, model, _ = _jax_and_port(config, 16, seed=1)
        ours = convert.params_from_jax(params, model)
        ref = params_to_torch_unet_state_dict(params, jmodel)
        assert ours.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(ours[k].numpy(), ref[k], err_msg=k)

    def test_full_width_export_keys_load_strict(self):
        jmodel = jax_unet_6stage()
        shapes = jax.eval_shape(
            lambda: jmodel.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3))))["params"]
        params = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
        sd = {k: torch.from_numpy(v) for k, v in
              params_to_torch_unet_state_dict(params, jmodel).items()}
        model = unet_6stage(device="cpu")
        model.load_state_dict(sd, strict=True)
        assert len(sd) == len(model.state_dict())

    def test_checkpoint_roundtrip(self, tmp_path):
        model = unet_6stage(dtype=torch.bfloat16, device="cpu",
                            generator=torch.Generator().manual_seed(5))
        path = tmp_path / "model.pth"
        convert.save_reference_checkpoint(model, path)
        ckpt = torch.load(str(path), weights_only=True)
        assert set(ckpt) == {"epoch", "model_state_dict", "best_dice"}
        assert all(v.dtype == torch.float32 for v in ckpt["model_state_dict"].values())
        loaded = convert.load_reference_checkpoint(path, device="cpu", dtype=torch.bfloat16)
        assert not loaded.training
        for (k, a), b in zip(model.state_dict().items(), loaded.state_dict().values()):
            assert torch.equal(a, b), k

    def test_init_is_seeded_kaiming_fan_out(self):
        a = UNet(**NARROW6, generator=torch.Generator().manual_seed(3))
        b = UNet(**NARROW6, generator=torch.Generator().manual_seed(3))
        for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(va, vb), k
        w = unet_6stage(device="cpu").encoder_stages[4].block[0].weight  # 3x3, 512 out
        assert abs(w.std().item() - np.sqrt(2.0 / (9 * 512))) < 2e-3
        norm = a.encoder_stages[0].block[1]
        assert torch.equal(norm.weight, torch.ones(8)) and torch.equal(norm.bias, torch.zeros(8))


class TestOps:
    def test_normalize_bitwise(self):
        np.testing.assert_array_equal(torch_normalize.IMAGENET_MEAN, JAX_MEAN)
        np.testing.assert_array_equal(torch_normalize.IMAGENET_STD, JAX_STD)
        img = np.random.default_rng(0).integers(0, 256, (2, 8, 8, 3)).astype(np.uint8)
        got = torch_normalize.normalize_image(torch.from_numpy(img))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax_normalize(jnp.asarray(img))))
        f = torch.ones(1, 2, 2, 3)
        assert torch_normalize.normalize_image(f) is f

    @pytest.mark.parametrize("in_size,out_size", [((5, 5), (9, 9)), ((17, 23), (8, 40)),
                                                  ((16, 16), (32, 32))])
    def test_resize_bilinear(self, in_size, out_size):
        x = np.random.default_rng(1).normal(size=(2, *in_size, 4)).astype(np.float32)
        got = resize_bilinear(torch.from_numpy(x), out_size)
        want = np.asarray(jax_resize_bilinear(jnp.asarray(x), out_size))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)

    def test_colorize_mask(self):
        mask = np.random.default_rng(2).choice([0, 1, 2, 255], (7, 9)).astype(np.uint8)
        np.testing.assert_array_equal(colorize_mask(mask), jax_colorize(mask))


class TestDevicePolicy:
    def test_no_silent_cpu(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            default_device()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            unet_6stage()
        assert default_device("cpu") == torch.device("cpu")


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py's imports, load without
    JAX or the JAX package (a fresh process: conftest imports jax here)."""
    code = r"""
import importlib, json, pkgutil, sys
sys.path.insert(0, sys.argv[1])
import unet_implementations_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
banned = ("jax", "jaxlib", "flax", "optax", "orbax", "unet_implementations_tpu")
bad = sorted(m for m in sys.modules
             if any(m == b or m.startswith(b + ".") for b in banned))
print(json.dumps({"modules": names, "bad": bad, "cv2": "cv2" in sys.modules,
                  "PIL": "PIL" in sys.modules, "yaml": "yaml" in sys.modules,
                  "matplotlib": "matplotlib" in sys.modules,
                  "sklearn": "sklearn" in sys.modules}))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code, str(REPO)], capture_output=True,
                         text=True, env=env, cwd=str(REPO), timeout=120)
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["bad"] == []
    # cv2 is imported only where a file is decoded (the card has none), and
    # yaml only where an augmentation policy file is read.
    assert result["cv2"] is False
    assert result["yaml"] is False
    # PIL only where a mask is read or written (the raw-data tools).
    assert result["PIL"] is False
    # matplotlib and scikit-learn only where a figure is drawn or the latent
    # space analysed (the card machine may lack both).
    assert result["matplotlib"] is False
    assert result["sklearn"] is False
    assert "unet_implementations_tpu_torch.recipes.common" in result["modules"]
    for name in ("kernels.instance_norm", "kernels.upsample", "kernels.s2d_region",
                 "kernels.winograd", "ops.s2d", "ops.losses", "ops.metrics",
                 "training.train_state", "training.steps", "data.synthetic",
                 "data.loader", "training.early_stopping", "training.checkpoint",
                 "training.loop", "recipes.our_unet", "models.vgg", "recipes.ae_recon",
                 "recipes.ae_transfer", "models.clip", "recipes.clip_unet", "data.pipeline",
                 "data.augment", "parallel", "parallel.distributed", "parallel.mesh", "cli",
                 "serving", "serving.export", "data.sanity_checks", "data.download",
                 "utils.dataset_analyzer", "utils.helpers", "utils.visualize",
                 "utils.gradcam", "utils.profiling"):
        assert f"unet_implementations_tpu_torch.{name}" in result["modules"]
