"""``UNet(remat=True)``: each block recomputed in the backward (JAX's ``nn.remat``).

- With channel dropout on (rates 0.1-0.3) and the same generator seed, a
  remat step equals the plain step bit for bit on the CPU: the loss, every
  gradient, and the generator's state after the step. The recompute reruns
  the same ops on the same inputs, and ``remat_call`` hands each run a fresh
  generator set to the state the caller's had, so it draws the same masks.
- Control: a checkpoint that passes the caller's generator itself (no state
  handling) draws new masks in the recompute, and its gradients differ.
- At dropout rates 0, two remat train steps against JAX's
  ``UNet(remat=True)`` at ``tests/test_torch_train.py``'s tolerances (loss
  1e-5 relative, every parameter 1e-5 relative L2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from unet_implementations_tpu.models.unet import UNet as JaxUNet
from unet_implementations_tpu.training import steps as jax_steps
from unet_implementations_tpu.training import train_state as jax_ts
from unet_implementations_tpu_torch.data.synthetic import as_uint8, synthetic_batch
from unet_implementations_tpu_torch.models import convert
from unet_implementations_tpu_torch.models import unet as unet_module
from unet_implementations_tpu_torch.models.unet import S2D_LAYOUT, UNet
from unet_implementations_tpu_torch.training import steps, train_state

DROPOUT3 = dict(features_per_stage=(8, 16, 32), strides=(1, 2, 2),
                encoder_dropout_rates=(0.0, 0.1, 0.3), decoder_dropout_rates=(0.2, 0.1))
TINY3 = dict(features_per_stage=(8, 16, 32), strides=(1, 2, 2),
             encoder_dropout_rates=(0.0, 0.0, 0.0), decoder_dropout_rates=(0.0, 0.0))


def _step(remat: bool, layout: dict):
    """Loss, gradients and the generator's state after one forward and
    backward of a seeded model in training mode."""
    model = UNet(**DROPOUT3, **layout, remat=remat,
                 generator=torch.Generator().manual_seed(5)).train()
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 32, 32, 3)).astype(
        np.float32))
    gen = torch.Generator().manual_seed(9)
    out = model(x, generator=gen)
    loss = (out.square().mean() + out[..., 1].mean())
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return loss.detach(), grads, gen.get_state()


@pytest.mark.parametrize("layout", ["dense", "s2d"])
def test_remat_step_equals_plain_step(layout):
    flags = S2D_LAYOUT if layout == "s2d" else {}
    loss, grads, state = _step(False, flags)
    r_loss, r_grads, r_state = _step(True, flags)
    assert torch.equal(loss, r_loss)
    assert grads.keys() == r_grads.keys()
    for name in grads:
        assert torch.equal(grads[name], r_grads[name]), name
    assert torch.equal(state, r_state)


def test_without_state_handling_the_masks_differ(monkeypatch):
    """The control: the caller's generator passed straight through the
    checkpoint. The forward draws the plain step's masks (equal loss), the
    recompute draws the next ones, and the gradients move."""
    loss, grads, _ = _step(False, {})

    def naive(fn, args, generator):
        return checkpoint(lambda *a: fn(*a, generator), *args, use_reentrant=False)

    monkeypatch.setattr(unet_module, "remat_call", naive)
    n_loss, n_grads, _ = _step(True, {})
    assert torch.equal(loss, n_loss)
    assert any(not torch.equal(grads[n], n_grads[n]) for n in grads)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


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


@pytest.mark.parametrize("layout", ["dense", "s2d"])
def test_remat_steps_match_jax(layout):
    flags = S2D_LAYOUT if layout == "s2d" else {"s2d_level0": False,
                                                "s2d_low_channel_decoders": False}
    jmodel = JaxUNet(**TINY3, **flags, remat=True)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0),
                            jnp.zeros((2, 32, 32, 3), jnp.float32))["params"]
    params = jax.tree.map(jnp.asarray, _seeded_params(shapes, np.random.default_rng(31)))
    tx = jax_ts.sgd_nesterov()
    state = jax_ts.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                              opt_state=tx.init(params), tx=tx, apply_fn=jmodel.apply)
    model = UNet(**TINY3, **flags, remat=True)
    model.load_state_dict(convert.params_from_jax(params, model), strict=True)
    jstep = jax_steps.make_segmentation_train_step(donate=False)
    step = steps.make_segmentation_train_step(model, train_state.sgd_nesterov(
        model.parameters()))
    for seed in (31, 32):
        batch = as_uint8(synthetic_batch(seed, 2, 32))
        state, jloss = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()},
                             jax.random.key(0))
        loss = step(batch, torch.Generator().manual_seed(0))
        assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
        want = convert.params_from_jax(jax.device_get(state.params), model)
        for key, value in model.state_dict().items():
            assert _rel(value.numpy(), want[key].numpy()) <= 1e-5, key
