"""The port's reconstruction path (unet_implementations_tpu_torch) against JAX.

On the same numpy inputs and weights:

- ``normalize_image(mode="unit")``: bitwise;
- ``mse_loss``, ``psnr``, ``ssim`` (per image and ``size_average``),
  ``ssim_loss`` and ``reconstruction_loss`` (with its gradient): 1e-5
  relative, SSIM 1e-4 (as ``tests/test_losses.py`` holds JAX's to a torch
  oracle); ``perceptual_loss`` with a VGG16 converted from JAX params at 32²
  float32, both forms of its feature functions: 1e-4, its gradient too;
- the reconstruction UNet (a 6-stage narrow model at 64² f32) against JAX's
  ``UNet(head="reconstruction")``: rtol 1e-3 / atol 1e-4, dense and s2d, the
  bottleneck too; s2d against dense to 1e-5 relative L2; the full-width
  ``autoencoder_6stage`` keys equal JAX's export and load strictly;
- two reconstruction train steps with Adam-L2 (3-stage UNet, dropout 0)
  against JAX's ``make_reconstruction_train_step``, the composite-loss step
  against ``recipes/ae_recon.py::make_train_step``, and the eval step: loss
  and parameters 1e-5 relative. Adam's first steps move an element by about
  the learning rate times the sign of its L2-decayed gradient, so an
  element whose decayed gradient lies within rounding of zero takes a step
  that the two frameworks' rounding decides. That is every element of a
  conv bias that an InstanceNorm follows (the norm cancels it: its exact
  gradient is zero), held to one learning rate per step; elsewhere at most
  0.1% of a tensor's elements (at least one) may be off by up to that,
  and the rest are held to 1e-5 relative;
- a transfer step (encoder frozen) against JAX's ``with_frozen`` step: the
  encoder bitwise unchanged, the decoders and head 1e-5 relative;
- the loader's reconstruction mode bit for bit against JAX's on a
  cv2-written dataset, and decode caches each package reads from the other;
- ``synthetic_batch(reconstruction=True)`` equal to JAX's;
- ``evaluate_reconstruction`` against JAX's on the same reconstructions:
  1e-5 relative, the same keys.
"""

import json

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_implementations_tpu.data import loader as jax_loader
from unet_implementations_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from unet_implementations_tpu.models import vgg as jax_vgg
from unet_implementations_tpu.models.convert import params_to_torch_unet_state_dict
from unet_implementations_tpu.models.unet import UNet as JaxUNet
from unet_implementations_tpu.models.unet import autoencoder_6stage as jax_autoencoder_6stage
from unet_implementations_tpu.models.unet import encoder_param_names as jax_encoder_names
from unet_implementations_tpu.ops import losses as jax_losses
from unet_implementations_tpu.ops.normalize import normalize_image as jax_normalize
from unet_implementations_tpu.recipes import ae_recon as jax_ae_recon
from unet_implementations_tpu.recipes import common as jax_common
from unet_implementations_tpu.training import steps as jax_steps
from unet_implementations_tpu.training import train_state as jax_ts
from unet_implementations_tpu_torch.data import loader
from unet_implementations_tpu_torch.data.synthetic import synthetic_batch
from unet_implementations_tpu_torch.models import convert, vgg
from unet_implementations_tpu_torch.models.unet import (
    AE_DEC_DROPOUT,
    AE_ENC_DROPOUT,
    S2D_LAYOUT,
    UNet,
    autoencoder_6stage,
    encoder_param_names,
)
from unet_implementations_tpu_torch.ops import losses
from unet_implementations_tpu_torch.ops.normalize import normalize_image
from unet_implementations_tpu_torch.recipes import ae_recon, common
from unet_implementations_tpu_torch.training import steps, train_state

# A 6-stage narrow model (32 channels at stage 1: JAX runs decoder_3 in s2d)
# and a 3-stage one for the train steps, both with the reconstruction head.
NARROW6 = dict(features_per_stage=(8, 32, 16, 16, 16, 16), head="reconstruction")
TINY3 = dict(features_per_stage=(8, 16, 32), strides=(1, 2, 2),
             encoder_dropout_rates=(0.0,) * 3, decoder_dropout_rates=(0.0,) * 2)
LAYOUTS = {"dense": {"s2d_level0": False, "s2d_low_channel_decoders": False}, "s2d": S2D_LAYOUT}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _seeded_params(tree, rng):
    """Values for a JAX params tree: Kaiming fan_out kernels, non-trivial
    biases and norm affines."""
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


def _pair(seed, size=16):
    rng = np.random.default_rng(seed)
    a = rng.random((2, size, size, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    return a, b


class TestNormalizeUnit:
    def test_bitwise(self):
        img = np.random.default_rng(0).integers(0, 256, (2, 8, 8, 3)).astype(np.uint8)
        got = normalize_image(torch.from_numpy(img), mode="unit")
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jax_normalize(jnp.asarray(img), mode="unit")))
        f = torch.rand(1, 2, 2, 3)
        assert normalize_image(f, mode="unit") is f
        with pytest.raises(ValueError, match="unknown normalize mode"):
            normalize_image(torch.from_numpy(img), mode="other")


class TestLosses:
    def test_mse_and_psnr(self):
        a, b = _pair(1)
        got = losses.mse_loss(torch.from_numpy(a), torch.from_numpy(b))
        assert abs(float(got) - float(jax_losses.mse_loss(a, b))) <= 1e-5 * float(got)
        p = losses.psnr(torch.from_numpy(a), torch.from_numpy(b))
        assert tuple(p.shape) == (2,)
        np.testing.assert_allclose(p.numpy(), np.asarray(jax_losses.psnr(a, b)), rtol=1e-5)
        # Identical images: the MSE clamps at 1e-10, 100 dB.
        np.testing.assert_allclose(losses.psnr(torch.from_numpy(a), torch.from_numpy(a)).numpy(),
                                   np.asarray(jax_losses.psnr(a, a)), rtol=1e-5)

    @pytest.mark.parametrize("size_average", [False, True])
    @pytest.mark.parametrize("kernel_size,size", [(11, 24), (7, 16), (11, 8)])
    def test_ssim(self, size_average, kernel_size, size):
        a, b = _pair(kernel_size + size, size)
        got = losses.ssim(torch.from_numpy(a), torch.from_numpy(b), kernel_size=kernel_size,
                          size_average=size_average)
        want = np.asarray(jax_losses.ssim(jnp.asarray(a), jnp.asarray(b), kernel_size=kernel_size,
                                          size_average=size_average))
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)

    def test_gaussian_window(self):
        np.testing.assert_allclose(losses._gaussian_window(11, 1.5).numpy(),
                                   np.asarray(jax_losses._gaussian_window(11, 1.5)), rtol=1e-6)

    def test_ssim_loss(self):
        a, b = _pair(3, 24)
        got = float(losses.ssim_loss(torch.from_numpy(a), torch.from_numpy(b)))
        want = float(jax_losses.ssim_loss(jnp.asarray(a), jnp.asarray(b)))
        assert abs(got - want) <= 1e-5 * abs(want)

    @pytest.mark.parametrize("weights", [(1.0, 0.0), (1.0, 0.5), (0.3, 2.0)])
    def test_reconstruction_loss_and_grad(self, weights):
        mse_w, ssim_w = weights
        a, b = _pair(4, 24)
        want, gwant = jax.value_and_grad(lambda p: jax_losses.reconstruction_loss(
            p, jnp.asarray(b), mse_weight=mse_w, ssim_weight=ssim_w))(jnp.asarray(a))
        at = torch.from_numpy(a).requires_grad_()
        got = losses.reconstruction_loss(at, torch.from_numpy(b), mse_weight=mse_w,
                                         ssim_weight=ssim_w)
        got.backward()
        got = got.detach()
        assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
        assert _rel(at.grad.numpy(), gwant) <= 1e-5


@pytest.fixture(scope="module")
def vgg_pair():
    """JAX's VGG16 features on random init at 32², and the port's with the
    same weights."""
    fn = jax_vgg.make_features_fn(jax.random.key(3), input_shape=(1, 32, 32, 3))
    params = fn.args[0]["params"]
    model = vgg.VGG16Features()
    model.load_state_dict(vgg.vgg_params_from_jax(params, model), strict=True)
    return fn, params, model.eval().requires_grad_(False)


class TestPerceptual:
    def test_features_equal_jax(self, vgg_pair):
        fn, _, model = vgg_pair
        x = np.random.default_rng(5).normal(size=(2, 32, 32, 3)).astype(np.float32)
        want = fn(jnp.asarray(x))
        got = model(torch.from_numpy(x))
        assert sorted(got) == sorted(want)
        for tap in want:
            assert tuple(got[tap].shape) == want[tap].shape
            assert _rel(got[tap].numpy(), want[tap]) <= 1e-4, tap

    @pytest.mark.parametrize("form", ["dict", "list"])
    def test_perceptual_loss_and_grad(self, vgg_pair, form):
        fn, params, model = vgg_pair
        a, b = _pair(6, 32)
        jfns = fn if form == "dict" else jax_vgg.make_feature_fns(
            jax.random.key(3), input_shape=(1, 32, 32, 3), params=params)
        tfns = model if form == "dict" else [
            (lambda t: (lambda x: model(x)[t]))(t) for t in vgg.DEFAULT_TAPS]
        want, gwant = jax.value_and_grad(lambda p: jax_losses.perceptual_loss(
            p, jnp.asarray(b), jfns))(jnp.asarray(a))
        at = torch.from_numpy(a).requires_grad_()
        got = losses.perceptual_loss(at, torch.from_numpy(b), tfns)
        got.backward()
        got = got.detach()
        assert abs(float(got) - float(want)) <= 1e-4 * abs(float(want))
        assert _rel(at.grad.numpy(), gwant) <= 1e-4

    def test_reconstruction_loss_with_perceptual(self, vgg_pair):
        fn, _, model = vgg_pair
        a, b = _pair(7, 32)
        want = float(jax_losses.reconstruction_loss(jnp.asarray(a), jnp.asarray(b), 1.0, 0.5,
                                                    0.2, feature_fns=fn))
        got = float(losses.reconstruction_loss(torch.from_numpy(a), torch.from_numpy(b), 1.0,
                                               0.5, 0.2, feature_fns=model))
        assert abs(got - want) <= 1e-4 * abs(want)

    def test_make_features_fn_is_frozen_and_seeded(self):
        a = vgg.make_features_fn(torch.Generator().manual_seed(2), taps=("relu1_2",),
                                 device="cpu")
        b = vgg.make_features_fn(torch.Generator().manual_seed(2), taps=("relu1_2",),
                                 device="cpu")
        assert not a.training and not any(p.requires_grad for p in a.parameters())
        assert list(a.state_dict()) == ["convs.conv1_1.weight", "convs.conv1_1.bias",
                                        "convs.conv1_2.weight", "convs.conv1_2.bias"]
        for va, vb in zip(a.state_dict().values(), b.state_dict().values()):
            assert torch.equal(va, vb)
        x = torch.rand(1, 8, 8, 3, requires_grad=True)
        a(x)["relu1_2"].sum().backward()
        assert x.grad is not None


def _jax_and_port(config, size, seed, **layout):
    jmodel = JaxUNet(**config)
    rng = np.random.default_rng(seed)
    x = rng.random((2, size, size, 3)).astype(np.float32)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.asarray(x))["params"]
    params = _seeded_params(shapes, rng)
    model = UNet(**config, **layout).eval()
    model.load_state_dict(convert.params_from_jax(params, model), strict=True)
    return jmodel, params, model, x


class TestReconstructionModel:
    @pytest.mark.parametrize("layout", ["dense", "s2d"])
    def test_forward_matches_jax(self, layout):
        jmodel, params, model, x = _jax_and_port(NARROW6, 64, seed=8, **LAYOUTS[layout])
        want, want_z = jax.jit(lambda p, v: jmodel.apply({"params": p}, v,
                                                         return_bottleneck=True))(
            params, jnp.asarray(x))
        with torch.no_grad():
            got, z = model(torch.from_numpy(x), return_bottleneck=True)
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        assert float(got.min()) >= 0 and float(got.max()) <= 1
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-4)
        assert tuple(z.shape) == want_z.shape
        np.testing.assert_allclose(z.numpy(), np.asarray(want_z), rtol=1e-3, atol=1e-4)

    def test_s2d_matches_dense(self):
        dense = UNet(**NARROW6, generator=torch.Generator().manual_seed(4)).eval()
        s2d = UNet(**NARROW6, **S2D_LAYOUT).eval()
        s2d.load_state_dict(dense.state_dict(), strict=True)
        x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(9))
        with torch.no_grad():
            want, got = dense(x), s2d(x)
        assert float((got - want).norm() / want.norm()) <= 1e-5

    def test_params_from_jax_equals_reference_export(self):
        jmodel, params, model, _ = _jax_and_port(NARROW6, 16, seed=1)
        ours = convert.params_from_jax(params, model)
        ref = params_to_torch_unet_state_dict(params, jmodel)
        assert ours.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(ours[k].numpy(), ref[k], err_msg=k)

    def test_full_width_keys_load_strict(self, tmp_path):
        jmodel = jax_autoencoder_6stage()
        shapes = jax.eval_shape(
            lambda: jmodel.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3))))["params"]
        params = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
        sd = {k: torch.from_numpy(v) for k, v in
              params_to_torch_unet_state_dict(params, jmodel).items()}
        model = autoencoder_6stage(device="cpu")
        assert list(sd) == list(model.state_dict())
        model.load_state_dict(sd, strict=True)
        assert model.encoder_dropout_rates == AE_ENC_DROPOUT
        assert model.decoder_dropout_rates == AE_DEC_DROPOUT
        # A JAX export_torch .pth loads strictly through the arch switch.
        path = tmp_path / "ae.pth"
        torch.save({"epoch": 0, "model_state_dict": sd}, str(path))
        loaded = convert.load_reference_checkpoint(path, device="cpu", arch="ae_recon")
        assert loaded.head == "reconstruction" and not loaded.training
        with pytest.raises(RuntimeError, match="segmentation_output"):
            convert.load_reference_checkpoint(path, device="cpu", arch="ae_transfer")
        # clip_unet is the segmentation model with the fusion: an AE file
        # does not fit it.
        with pytest.raises(RuntimeError, match="reconstruction_output"):
            convert.load_reference_checkpoint(path, device="cpu", arch="clip_unet")
        with pytest.raises(ValueError, match="unknown arch"):
            convert.load_reference_checkpoint(path, device="cpu", arch="other")

    def test_encoder_names(self):
        assert len(encoder_param_names()) == len(jax_encoder_names()) == 6
        model = UNet(**TINY3)
        for name in encoder_param_names(3):
            model.get_submodule(name)
        with pytest.raises(ValueError, match="head"):
            UNet(**TINY3, head="other")


def _training_pair(seed, layout="dense", head="reconstruction", size=32):
    config = dict(TINY3, head=head)
    jmodel = JaxUNet(**config, **LAYOUTS[layout])
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0),
                            jnp.zeros((2, size, size, 3), jnp.float32))["params"]
    params = jax.tree.map(jnp.asarray, _seeded_params(shapes, np.random.default_rng(seed)))
    model = UNet(**config, **LAYOUTS[layout])
    model.load_state_dict(convert.params_from_jax(params, model), strict=True)
    return jmodel, params, model


def _assert_adam_params_match(model, want, n_steps, lr=1e-3):
    """The module docstring's rule for parameters after ``n_steps`` Adam
    steps."""
    for key, value in model.state_dict().items():
        diff = (value - want[key]).abs().reshape(-1)
        assert float(diff.max()) <= n_steps * lr, key
        prefix = key.rsplit(".", 1)[0]
        if (key.endswith(".bias") and ".block." in key
                and isinstance(model.get_submodule(prefix), torch.nn.Conv2d)):
            continue
        n_noise = max(1, value.numel() // 1000)
        kept = diff.argsort()[:value.numel() - n_noise]
        a, b = value.reshape(-1)[kept], want[key].reshape(-1)[kept]
        assert _rel(a.numpy(), b.numpy()) <= 1e-5, key


def _state(jmodel, params, tx):
    return jax_ts.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                             opt_state=tx.init(params), tx=tx, apply_fn=jmodel.apply)


def _recon_batch(seed, size=32, uint8=True):
    batch = synthetic_batch(seed, 2, size, reconstruction=True)
    if uint8:
        pixels = np.clip(np.rint(batch["image"] * 255.0), 0, 255).astype(np.uint8)
        batch = {"image": pixels, "target": pixels.copy()}
    return batch


class TestReconstructionSteps:
    @pytest.mark.parametrize("layout", ["dense", "s2d"])
    def test_two_steps_match_jax(self, layout):
        jmodel, params, model = _training_pair(21, layout)
        state = _state(jmodel, params, jax_ts.adam_l2())
        jstep = jax_steps.make_reconstruction_train_step(donate=False)
        step = steps.make_reconstruction_train_step(model, train_state.adam_l2(model.parameters()))
        for n, b in enumerate((_recon_batch(22), _recon_batch(23, uint8=False))):
            state, jloss = jstep(state, {k: jnp.asarray(v) for k, v in b.items()},
                                 jax.random.key(0))
            loss = step(b, torch.Generator().manual_seed(0))
            assert loss.dtype == torch.float32 and loss.ndim == 0
            assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
            _assert_adam_params_match(
                model, convert.params_from_jax(jax.device_get(state.params), model), n + 1)

    def test_composite_step_matches_jax(self):
        jmodel, params, model = _training_pair(24)
        state = _state(jmodel, params, jax_ts.adam_l2())
        jstep = jax_ae_recon.make_train_step(mse_weight=0.7, ssim_weight=0.5, donate=False)
        step = ae_recon.make_train_step(model, train_state.adam_l2(model.parameters()),
                                        mse_weight=0.7, ssim_weight=0.5)
        b = _recon_batch(25)
        state, jloss = jstep(state, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.key(0))
        loss = step(b, torch.Generator().manual_seed(0))
        assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
        _assert_adam_params_match(
            model, convert.params_from_jax(jax.device_get(state.params), model), 1)

    def test_perceptual_needs_feature_fns(self):
        with pytest.raises(ValueError, match="feature_fns"):
            ae_recon.make_loss_fn(perceptual_weight=0.1)
        with pytest.raises(ValueError, match="feature_fns"):
            jax_ae_recon.make_loss_fn(perceptual_weight=0.1)

    @pytest.mark.parametrize("layout", ["dense", "s2d"])
    def test_eval_step_matches_jax(self, layout):
        jmodel, params, model = _training_pair(26, layout)
        b = _recon_batch(27)
        want = jax_steps.make_reconstruction_eval_step()(
            _state(jmodel, params, jax_ts.adam_l2()), {k: jnp.asarray(v) for k, v in b.items()})
        got = steps.make_reconstruction_eval_step(model)(b)
        assert not model.training
        assert got.keys() == want.keys()
        for k in want:
            assert tuple(got[k].shape) == want[k].shape, k
            assert _rel(got[k].numpy(), want[k]) <= 1e-5, k


class TestTransferStep:
    @pytest.mark.parametrize("layout", ["dense", "s2d"])
    def test_frozen_encoder_matches_jax(self, layout):
        """JAX masks the encoder's updates to zero (``with_frozen``); the
        port freezes its parameters and gives the optimizer the rest."""
        jmodel, params, model = _training_pair(31, layout, head="segmentation")
        tx = jax_ts.with_frozen(jax_ts.sgd_nesterov(), params, list(jax_encoder_names(3)))
        state = _state(jmodel, params, tx)
        jstep = jax_steps.make_segmentation_train_step(donate=False)
        train_state.with_frozen(model, ["encoder_stages"])
        step = steps.make_segmentation_train_step(model, train_state.sgd_nesterov(
            [p for p in model.parameters() if p.requires_grad]))
        before = {k: v.clone() for k, v in model.state_dict().items()}
        for seed in (32, 33):
            b = synthetic_batch(seed, 2, 32)
            state, jloss = jstep(state, {k: jnp.asarray(v) for k, v in b.items()},
                                 jax.random.key(0))
            loss = step(b, torch.Generator().manual_seed(0))
            assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
            want = convert.params_from_jax(jax.device_get(state.params), model)
            for key, value in model.state_dict().items():
                if key.startswith("encoder_stages."):
                    assert torch.equal(value, before[key]), key
                    np.testing.assert_array_equal(want[key].numpy(), value.numpy(), err_msg=key)
                else:
                    assert not torch.equal(value, before[key]), key
                    assert _rel(value.numpy(), want[key].numpy()) <= 1e-5, key


# --- the loader's reconstruction mode ----------------------------------------

TARGET = (48, 48)
ORIGINALS = [(40, 56), (64, 48), (33, 71)]


@pytest.fixture
def recon_dirs(tmp_path):
    """``Train/resized`` jpgs, their ``resized_label`` pngs (at other sizes
    than the images: the original dims come from the mask when one is
    given), and an ``augmented/images`` directory."""
    rng = np.random.default_rng(40)
    root = tmp_path / "data" / "Train"
    images, masks, aug = root / "resized", root / "resized_label", root / "augmented" / "images"
    for d in (images, masks, aug, root / "augmented" / "masks"):
        d.mkdir(parents=True)
    for i, (h, w) in enumerate(ORIGINALS):
        cv2.imwrite(str(images / f"img_{i}.jpg"), rng.integers(0, 256, (h, w, 3)).astype(np.uint8))
        cv2.imwrite(str(masks / f"img_{i}.png"), rng.integers(0, 3, (h + 2, w)).astype(np.uint8))
    cv2.imwrite(str(aug / "aug_0.jpg"), rng.integers(0, 256, (30, 50, 3)).astype(np.uint8))
    return images, masks


def _items(ds):
    return [ds.load_item(i) for i in range(len(ds))]


def _assert_items_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


class TestReconstructionLoader:
    @pytest.mark.parametrize("emit_uint8", [True, False])
    @pytest.mark.parametrize("with_masks", [False, True])
    def test_items_equal_jax(self, recon_dirs, emit_uint8, with_masks):
        images, masks = recon_dirs
        masks = masks if with_masks else None
        kw = dict(target_size=TARGET, mode="reconstruction", emit_uint8=emit_uint8,
                  include_augmented=not with_masks)
        got = _items(loader.PetDataset(images, masks, **kw))
        _assert_items_equal(got, _items(jax_loader.PetDataset(images, masks, **kw)))
        assert set(got[0]) == {"image", "target", "original_dims"}
        np.testing.assert_array_equal(got[0]["image"], got[0]["target"])
        assert got[0]["image"].dtype == (np.uint8 if emit_uint8 else np.float32)

    def test_batches_equal_jax(self, recon_dirs):
        images, _ = recon_dirs
        kw = dict(target_size=TARGET, mode="reconstruction", emit_uint8=True)
        ours = list(loader.batch_iterator(loader.PetDataset(images, None, **kw), 2, shuffle=True,
                                          seed=3))
        ref = list(jax_loader.batch_iterator(jax_loader.PetDataset(images, None, **kw), 2,
                                             shuffle=True, seed=3))
        _assert_items_equal(ours, ref)

    @pytest.mark.parametrize("built_by", ["jax", "port"])
    def test_cache_shared_with_jax(self, recon_dirs, tmp_path, monkeypatch, built_by):
        """A reconstruction cache built by either package opens in the other
        without a decode; it is a separate cache from the segmentation one."""
        images, masks = recon_dirs
        cache = tmp_path / "cache"
        kw = dict(target_size=TARGET, mode="reconstruction", emit_uint8=True, cache_dir=cache)
        build, read = ((jax_loader.PetDataset, loader.PetDataset) if built_by == "jax"
                       else (loader.PetDataset, jax_loader.PetDataset))
        built = build(images, masks, **kw)
        monkeypatch.setattr(read, "_decode", lambda self, idx: 1 / 0)
        _assert_items_equal(_items(read(images, masks, **kw)), _items(built))
        ours = loader.PetDataset(images, masks, **kw)
        d = ours.cache_path(cache)
        assert [p.name for p in cache.iterdir()] == [d.name]
        assert not (d / "masks.npy").exists()
        assert json.loads((d / loader.MANIFEST).read_text()) == loader.cache_identity(
            ours.image_files, TARGET, True, "reconstruction")
        seg = loader.PetDataset(images, masks, target_size=TARGET, emit_uint8=True)
        assert seg.cache_path(cache) != d

    def test_write_cache_serves_reconstruction(self, recon_dirs, tmp_path, monkeypatch):
        images, _ = recon_dirs
        ref = loader.PetDataset(images, None, target_size=TARGET, mode="reconstruction",
                                include_augmented=False, emit_uint8=True)
        raws = [ref._decode(i) for i in range(len(ref))]
        cache = tmp_path / "cache"
        loader.write_cache(loader.cache_path(cache, images, None, TARGET,
                                             mode="reconstruction"),
                           loader.cache_identity(ref.image_files, TARGET, False, "reconstruction"),
                           iter(raws), len(raws), TARGET, False)
        monkeypatch.setattr(jax_loader.PetDataset, "_decode", lambda self, idx: 1 / 0)
        ours = jax_loader.PetDataset(images, None, target_size=TARGET, mode="reconstruction",
                                     include_augmented=False, emit_uint8=True, cache_dir=cache)
        _assert_items_equal(_items(ours), [ref._finalize(r) for r in raws])

    def test_unknown_mode_raises(self, recon_dirs):
        with pytest.raises(ValueError, match="mode"):
            loader.PetDataset(recon_dirs[0], None, mode="clip")


def test_synthetic_reconstruction_batch_is_the_jax_one():
    ours, ref = (synthetic_batch(5, 2, 24, reconstruction=True),
                 jax_synthetic_batch(5, 2, 24, reconstruction=True))
    assert ours.keys() == ref.keys() == {"image", "target"}
    for k in ours:
        assert ours[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(ours[k], ref[k])


def test_evaluate_reconstruction_equals_jax(recon_dirs, tmp_path):
    images, _ = recon_dirs
    kw = dict(target_size=TARGET, mode="reconstruction", include_augmented=True)

    def recon(image):  # a fixed, image-dependent "reconstruction" in [0, 1]
        return np.clip(0.8 * image.astype(np.float32) / 255.0 + 0.1 * np.sin(
            np.arange(image.shape[2])[None, None, :, None]), 0, 1).astype(np.float32)

    # The port's dataset emits uint8 (its evaluate does); JAX's floats.
    ours = common.evaluate_reconstruction(
        lambda b: torch.from_numpy(recon(b["image"])),
        loader.PetDataset(images, None, emit_uint8=True, **kw), batch_size=3,
        output_dir=tmp_path / "ours", verbose=False)
    ref = jax_common.evaluate_reconstruction(
        lambda b: jnp.asarray(recon(np.rint(b["image"] * 255.0))),
        jax_loader.PetDataset(images, None, **kw), batch_size=3,
        output_dir=tmp_path / "ref", verbose=False)
    assert list(ours) == list(ref) == ["mse", "psnr", "ssim", "num_images"]
    assert ours["num_images"] == ref["num_images"] == len(ORIGINALS) + 1
    for k in ("mse", "psnr", "ssim"):
        assert abs(ours[k] - ref[k]) <= 1e-5 * abs(ref[k]), k
    assert json.loads((tmp_path / "ours" / "reconstruction_metrics.json").read_text()) == ours
