"""When an s2d ``ConvBlock`` of the port takes the fused tail (K3).

The JAX ``ConvBlock`` takes its fused tail only where ``region_applicable``
allows the shape, and is differentiated through its module path. The port's
block takes ``fused_s2d_tail`` only in eval mode, at a width K3 takes
(C in ``CHANNELS``), and when autograd would not record the call; otherwise
it runs its module path (IN -> lrelu -> conv_1 -> IN -> lrelu through K1).
A spy on ``blocks.fused_s2d_tail`` shows which path ran. The eval forward
with grad enabled is held to JAX's eval forward at the tolerance of
``tests/test_torch_model.py`` (rtol 1e-3, atol 1e-4, float32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_implementations_tpu.models.unet import UNet as JaxUNet
from unet_implementations_tpu_torch.kernels import s2d_region
from unet_implementations_tpu_torch.models import blocks, convert
from unet_implementations_tpu_torch.models.unet import S2D_LAYOUT, UNet

# Six narrow stages: level 0 (C = 8) and decoder_3 (C = 32) in s2d, three
# fused tails per eval forward.
NARROW6 = dict(features_per_stage=(8, 32, 16, 16, 16, 16))
# Level 0 at 48 channels, a width K3 does not take.
WIDE48 = dict(features_per_stage=(48, 64, 64), strides=(1, 2, 2))


@pytest.fixture
def tail_calls(monkeypatch):
    """Counts the calls of ``blocks.fused_s2d_tail``."""
    calls = []

    def spy(*args, **kwargs):
        calls.append(tuple(args[0].shape))
        return s2d_region.fused_s2d_tail(*args, **kwargs)

    monkeypatch.setattr(blocks, "fused_s2d_tail", spy)
    return calls


def _x(size=32, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=(2, size, size, 3)).astype(
        np.float32))


def test_eval_with_grad_takes_the_module_path(tail_calls):
    model = UNet(**NARROW6, **S2D_LAYOUT).eval()
    assert all(p.requires_grad for p in model.parameters())
    model(_x()).sum().backward()
    assert tail_calls == []
    assert all(p.grad is not None for p in model.parameters())


def test_eval_without_grad_takes_the_tail(tail_calls):
    model = UNet(**NARROW6, **S2D_LAYOUT).eval()
    with torch.no_grad():
        model(_x())
    assert len(tail_calls) == 3
    with torch.inference_mode():
        model(_x())
    assert len(tail_calls) == 6


def test_frozen_parameters_take_the_tail(tail_calls):
    """Grad mode on, but nothing requires grad: autograd records nothing."""
    model = UNet(**NARROW6, **S2D_LAYOUT).eval().requires_grad_(False)
    model(_x())
    assert len(tail_calls) == 3


def test_unsupported_width_takes_the_module_path(tail_calls):
    model = UNet(**WIDE48, s2d_level0=True, s2d_low_channel_decoders=False).eval()
    with torch.no_grad():
        out = model(_x())
    assert tail_calls == []
    assert out.shape == (2, 32, 32, 3) and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("c,want", [(8, True), (64, True), (24, False), (48, False)])
def test_region_applicable_shapes(c, want):
    x = torch.zeros(1, 4, 4, 4 * c)
    v = torch.ones(c)
    with torch.no_grad():
        assert s2d_region.region_applicable(x, v, v, torch.zeros(c, c, 3, 3), v, v) is want
    assert not s2d_region.region_applicable(torch.zeros(1, 4, 4, 4 * c + 2), v, v, v, v, v)
    assert not s2d_region.region_applicable(x.to(torch.float16), v, v, v, v, v)


def test_region_applicable_grad():
    x = torch.zeros(1, 4, 4, 32)
    v = torch.ones(8)
    w = torch.zeros(8, 8, 3, 3, requires_grad=True)
    assert not s2d_region.region_applicable(x, v, v, w, v, v)
    assert not s2d_region.region_applicable(x.requires_grad_(), v, v, v, v, v)
    assert s2d_region.region_applicable(x.detach(), v, v, w.detach(), v, v)
    with torch.no_grad():
        assert s2d_region.region_applicable(x, v, v, w, v, v)


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


@pytest.mark.parametrize("config,flags", [
    (NARROW6, S2D_LAYOUT), (WIDE48, {"s2d_level0": True, "s2d_low_channel_decoders": False})],
    ids=["narrow6", "wide48"])
def test_eval_forward_with_grad_matches_jax(config, flags, tail_calls):
    jmodel = JaxUNet(**config, **flags)
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.asarray(x))["params"]
    params = _seeded_params(shapes, rng)
    model = UNet(**config, **flags).eval()
    model.load_state_dict(convert.params_from_jax(params, model), strict=True)
    want = np.asarray(jax.jit(lambda p, a: jmodel.apply({"params": p}, a))(params,
                                                                          jnp.asarray(x)))
    got = model(torch.from_numpy(x))
    assert got.requires_grad and tail_calls == []
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-3, atol=1e-4)


def _up_block_state(tree) -> dict:
    """JAX ``UpBlock`` params -> the port's ``UpBlock`` state dict (dropout 0:
    three slots a conv)."""
    sd = {}
    for j in range(2):
        conv, norm = tree["conv_block"][f"conv_{j}"], tree["conv_block"][f"norm_{j}"]
        sd[f"conv_block.block.{3 * j}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.transpose(np.asarray(conv["kernel"]), (3, 2, 0, 1))))
        sd[f"conv_block.block.{3 * j}.bias"] = torch.from_numpy(np.asarray(conv["bias"]))
        sd[f"conv_block.block.{3 * j + 1}.weight"] = torch.from_numpy(np.asarray(norm["scale"]))
        sd[f"conv_block.block.{3 * j + 1}.bias"] = torch.from_numpy(np.asarray(norm["bias"]))
    return sd


def test_dense_up_block_split_conv_matches_jax(monkeypatch):
    """The dense decoder passes [upsampled, skip] to conv_0 unconcatenated
    (its ``qconv_sum`` takes two segments) and matches JAX's ``UpBlock``, whose
    ``ConvOp`` sums the two segments' convs: float32 at this file's rtol 1e-3 /
    atol 1e-4; bf16 no further from JAX's float32 block than JAX's own bf16
    block is, within 25% of its rel-L2 (the bound of ``chip_smoke.py``'s bf16
    forwards, E2E_BF16_SLACK)."""
    from unet_implementations_tpu.models.blocks import UpBlock as JaxUpBlock

    rng = np.random.default_rng(17)
    x = rng.normal(size=(2, 8, 8, 16)).astype(np.float32)
    skip = rng.normal(size=(2, 16, 16, 8)).astype(np.float32)
    jblock = JaxUpBlock(features=8)
    shapes = jax.eval_shape(jblock.init, jax.random.key(0), jnp.asarray(x), jnp.asarray(skip))
    params = _seeded_params(shapes["params"], rng)

    def jax_out(dtype):
        block = JaxUpBlock(features=8, dtype=dtype)
        return np.asarray(block.apply({"params": params}, jnp.asarray(x, dtype),
                                      jnp.asarray(skip, dtype)).astype(jnp.float32))

    port = blocks.UpBlock(16, 8, 8).eval()
    port.load_state_dict(_up_block_state(params), strict=True)
    segments = []
    real_sum = blocks.qconv_sum

    def spy(xs, *a, **k):
        segments.append([tuple(xi.shape[:2]) for xi in xs])
        return real_sum(xs, *a, **k)

    monkeypatch.setattr(blocks, "qconv_sum", spy)

    def port_out(dtype):
        def nchw(a):
            return torch.from_numpy(a).to(dtype).permute(0, 3, 1, 2)
        with torch.no_grad():
            return port(nchw(x), nchw(skip)).permute(0, 2, 3, 1).float().numpy()

    want32, got32 = jax_out(jnp.float32), port_out(torch.float32)
    assert segments == [[(2, 16), (2, 8)], [(2, 8)]]
    np.testing.assert_allclose(got32, want32, rtol=1e-3, atol=1e-4)

    def rel(a):
        return float(np.linalg.norm(a - want32) / np.linalg.norm(want32))

    assert rel(port_out(torch.bfloat16)) <= 1.25 * rel(jax_out(jnp.bfloat16))
