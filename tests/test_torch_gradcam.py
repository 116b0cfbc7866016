"""The port's Grad-CAM and VGG16 weight loader against the JAX package's
(``utils/gradcam.py``, ``models/vgg.py::load_torch_vgg16_weights``).

- Grad-CAM of JAX's tiny UNet (``tests/test_gradcam_vgg.py``: features 8-16,
  dropout rates 0; the dense layout) and of a 3-stage one (whose target is at
  half the input's size, so the bilinear resize runs), weights carried by
  ``params_from_jax``, at 16² and 32² float32, for each class, at the first
  decoder block's output: the port's CAM within 1e-4 (max abs, [0, 1] units)
  of JAX's. At the default target (the first decoder conv, an InstanceNorm's
  input) the gradient's spatial mean is rounding noise in both, so the CAMs
  are not compared there; the port captures the same activation. A path that
  names no module, or a conv the forward does not reach, raises
  ``ValueError``; the hook is removed and the model's mode restored; the
  render writes a PNG.
- A random state dict in torchvision's VGG16 layout, written with
  ``torch.save``, loaded by JAX's loader and by the port's: the weights equal
  the file's bit for bit, and the four taps' features at 32² float32 agree to
  1e-4 relative L2 (``tests/test_torch_recon.py``'s VGG bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as flax_nn

from unet_implementations_tpu.models import vgg as jax_vgg
from unet_implementations_tpu.models.unet import UNet as JaxUNet
from unet_implementations_tpu.utils.gradcam import gradcam as jax_gradcam
from unet_implementations_tpu_torch.models import convert, vgg
from unet_implementations_tpu_torch.models.unet import UNet
from unet_implementations_tpu_torch.utils.gradcam import DEFAULT_TARGET, gradcam, visualize_gradcam

CAM_ATOL = 1e-4
VGG_REL_L2 = 1e-4
# Dense: JAX's default would run level 0, the tiny models' target level, in
# s2d (the full-width model's decoder_0 is dense in both layouts).
DENSE = dict(s2d_level0=False, s2d_low_channel_decoders=False)
TINY = dict(features_per_stage=(8, 16), strides=(1, 2),
            encoder_dropout_rates=(0.0, 0.0), decoder_dropout_rates=(0.0,), **DENSE)
TINY3 = dict(features_per_stage=(8, 16, 16), strides=(1, 2, 2),
             encoder_dropout_rates=(0.0, 0.0, 0.0), decoder_dropout_rates=(0.0, 0.0), **DENSE)


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


def _pair(config, size, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(1, size, size, 3)).astype(np.float32)
    jmodel = JaxUNet(**config)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.asarray(x))["params"]
    params = _seeded_params(shapes, rng)
    model = UNet(**config)
    model.load_state_dict(convert.params_from_jax(params, model), strict=True)
    return jmodel, params, model, x


# A block's output, after its norms: JAX's ("decoder_0", "conv_block").
BLOCK_TARGET = "decoder_stages.0.conv_block"


@pytest.mark.parametrize("config", [TINY, TINY3], ids=["tiny2", "tiny3"])
@pytest.mark.parametrize("size", [16, 32])
def test_cam_matches_jax(config, size):
    jmodel, params, model, x = _pair(config, size, seed=size + len(config["strides"]))
    for target_class in range(3):
        want = jax_gradcam(jmodel, params, jnp.asarray(x), target_class,
                           target_path=("decoder_0", "conv_block"))
        got = gradcam(model, torch.from_numpy(x), target_class, target=BLOCK_TARGET)
        assert got.shape == want.shape == (size, size) and got.dtype == np.float32
        assert 0.0 <= got.min() and got.max() <= 1.0 + 1e-6
        assert np.abs(got - want).max() <= CAM_ATOL, target_class


@pytest.mark.parametrize("config", [TINY, TINY3], ids=["tiny2", "tiny3"])
def test_default_target_weights_are_rounding_noise(config):
    """At the default target (a conv, whose output an InstanceNorm takes) the
    gradient's spatial mean is zero up to rounding, in JAX and in the port:
    each CAM there is its own noise's pattern, so the two are not compared.
    The port captures the activation JAX captures, and its gradient."""
    jmodel, params, model, x = _pair(config, 16, seed=7)
    captured = []

    def interceptor(next_fn, args, kwargs, context):
        out = next_fn(*args, **kwargs)
        if tuple(getattr(context.module, "path", ())) == ("decoder_0", "conv_block", "conv_0"):
            captured.append(out)
        return out

    with flax_nn.intercept_methods(interceptor):
        jmodel.apply({"params": params}, jnp.asarray(x), deterministic=True)
    norm = model.get_submodule(DEFAULT_TARGET.rpartition(".")[0])[1]
    acts = []
    handle = norm.register_forward_pre_hook(
        lambda m, args: (acts.append(args[0].detach().requires_grad_(True)) or acts[-1],
                         *args[1:]))
    try:
        logits = model.eval()(torch.from_numpy(x))
    finally:
        handle.remove()
    grad, = torch.autograd.grad(logits[..., 1].sum(), acts[0])
    act = acts[0].permute(0, 2, 3, 1).detach().numpy()
    assert np.abs(act - np.asarray(captured[0])).max() <= 1e-5
    g = grad.permute(0, 2, 3, 1).numpy()
    assert np.abs(g.mean(axis=(1, 2))).max() <= 1e-6 * np.abs(g).mean()
    cam = gradcam(model, x, 1)
    assert cam.shape == (16, 16) and 0.0 <= cam.min() and cam.max() <= 1.0 + 1e-6


def test_hook_removed_and_mode_restored():
    _, _, model, x = _pair(TINY, 16, seed=3)
    model.train()
    gradcam(model, x, 1)
    assert model.training
    assert not any(m._forward_pre_hooks for m in model.modules())
    assert all(p.grad is None for p in model.parameters())


@pytest.mark.parametrize("target", ["nope", "segmentation_output",
                                    "decoder_stages.3.conv_block.block.0"])
def test_bad_target_raises(target):
    _, _, model, x = _pair(TINY, 16, seed=4)
    with pytest.raises(ValueError):
        gradcam(model, x, 0, target=target)
    assert not any(m._forward_pre_hooks for m in model.modules())


def test_render(tmp_path):
    _, _, model, x = _pair(TINY, 16, seed=5)
    cam = visualize_gradcam(model, torch.from_numpy(x), 2, tmp_path / "cam.png")
    assert (tmp_path / "cam.png").stat().st_size > 0
    np.testing.assert_array_equal(cam, gradcam(model, x, 2, DEFAULT_TARGET))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_vgg16_loader_matches_jax(tmp_path):
    rng = np.random.default_rng(11)
    sd, cin = {}, 3
    for idx, (_, cout) in zip(vgg.TORCHVISION_CONV_INDICES,
                              [(b, ch) for b, (n, ch) in enumerate(vgg.VGG16_PLAN)
                               for _ in range(n)]):
        std = np.sqrt(2.0 / (9 * cout))
        sd[f"features.{idx}.weight"] = torch.from_numpy(
            (rng.normal(size=(cout, cin, 3, 3)) * std).astype(np.float32))
        sd[f"features.{idx}.bias"] = torch.from_numpy(
            (0.1 * rng.normal(size=cout)).astype(np.float32))
        cin = cout
    # torchvision's classifier keys ride along in a real file.
    sd["classifier.0.weight"] = torch.zeros(4, 8)
    path = tmp_path / "vgg16.pth"
    torch.save(sd, path)

    fn = jax_vgg.make_features_fn(jax.random.key(0), input_shape=(1, 32, 32, 3))
    jparams = jax_vgg.load_torch_vgg16_weights(path, fn.args[0]["params"])
    jfn = jax_vgg.make_features_fn(jax.random.key(0), input_shape=(1, 32, 32, 3),
                                   params=jparams)
    for source in (path, str(path), sd):
        model = vgg.load_torch_vgg16_weights(source, vgg.VGG16Features().eval())
        assert torch.equal(model.convs["conv1_1"].weight, sd["features.0.weight"])
        assert torch.equal(model.convs["conv4_3"].bias, sd["features.21.bias"])
    x = np.random.default_rng(12).random((2, 32, 32, 3)).astype(np.float32)
    want = jfn(jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert sorted(got) == sorted(want)
    for tap in want:
        assert _rel(got[tap].numpy(), want[tap]) <= VGG_REL_L2, tap

    del sd["features.28.weight"]  # conv5_3: no tap of the default trunk uses it
    vgg.load_torch_vgg16_weights(sd, vgg.VGG16Features())
    del sd["features.21.weight"]  # conv4_3: relu4_3's
    with pytest.raises(KeyError, match="features.21.weight"):
        vgg.load_torch_vgg16_weights(sd, vgg.VGG16Features())
