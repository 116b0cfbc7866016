"""The port's gradient accumulation against JAX's ``make_accum_train_step``.

At 32² on a 2-stage UNet (features 8-16, dense, float32, dropout rates 0, as
``tests/test_accum.py``), with the same seeded weights (carried by
``models/convert.py::params_from_jax``) and the same uint8 batch:

- ``training/steps.py::make_accum_train_step`` with
  ``make_segmentation_loss_fn`` (dynamic, static and no class weights) and
  with ``make_reconstruction_loss_fn`` (plain MSE, and the composite loss of
  ``recipes/ae_recon.py``) against JAX's accumulation step at accum 2, two
  steps with SGD-Nesterov: the loss to 1e-5 relative, every parameter to
  1e-5 relative L2 (``test_torch_train.py::test_two_steps_match_jax``'s
  bounds);
- port-only: ``accum=1`` is the plain step bit for bit (dropout on); the
  strided split and the microbatch generators against a hand-built
  ``batch[i::accum]`` loop, bit for bit; an indivisible batch and ``accum``
  < 1 raise; the transfer model's frozen encoder stays bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_implementations_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from unet_implementations_tpu.models.unet import UNet as JaxUNet
from unet_implementations_tpu.recipes import ae_recon as jax_ae_recon
from unet_implementations_tpu.training import steps as jax_steps
from unet_implementations_tpu.training import train_state as jax_ts
from unet_implementations_tpu_torch.data.synthetic import as_uint8
from unet_implementations_tpu_torch.models import convert
from unet_implementations_tpu_torch.models.unet import UNet, encoder_param_names
from unet_implementations_tpu_torch.recipes import ae_recon
from unet_implementations_tpu_torch.training import steps, train_state

# The dense layout in both packages (JAX's UNet defaults to s2d).
TINY = dict(features_per_stage=(8, 16), strides=(1, 2), s2d_level0=False,
            s2d_low_channel_decoders=False)
NO_DROPOUT = dict(encoder_dropout_rates=(0.0, 0.0), decoder_dropout_rates=(0.0,))
SIZE = 32
ACCUM = 2
LOSS_REL = 1e-5
PARAM_REL_L2 = 1e-5


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def seg_batch(seed: int, n: int = 4) -> dict:
    b = as_uint8(jax_synthetic_batch(seed, n, SIZE))
    return {k: b[k] for k in ("image", "mask")}


def recon_batch(seed: int, n: int = 4) -> dict:
    image = as_uint8(jax_synthetic_batch(seed, n, SIZE))["image"]
    return {"image": image, "target": image}


def seeded_params(tree, rng):
    """Weights from ``rng`` for JAX's parameter tree: He-scaled kernels, and
    norm scales and biases away from their init, so that a conv bias that an
    InstanceNorm cancels (exact gradient zero) is held relative to its own
    size, as in ``tests/test_torch_train.py``."""
    out = {}
    for name, node in tree.items():
        if isinstance(node, dict):
            out[name] = seeded_params(node, rng)
        elif name == "kernel":
            kh, kw, _, cout = node.shape
            out[name] = (rng.normal(size=node.shape) * np.sqrt(2.0 / (kh * kw * cout))).astype(
                np.float32)
        elif name == "scale":
            out[name] = (1.0 + 0.1 * rng.normal(size=node.shape)).astype(np.float32)
        else:
            out[name] = (0.1 * rng.normal(size=node.shape)).astype(np.float32)
    return out


def jax_and_port(head: str = "segmentation", seed: int = 0):
    """A JAX train state (SGD-Nesterov) with seeded weights, and the port's
    model with the same weights."""
    jmodel = JaxUNet(**TINY, **NO_DROPOUT, head=head)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0),
                            jnp.zeros((1, SIZE, SIZE, 3), jnp.float32))["params"]
    params = jax.tree.map(jnp.asarray, seeded_params(shapes, np.random.default_rng(seed)))
    tx = jax_ts.sgd_nesterov()
    state = jax_ts.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                              opt_state=tx.init(params), tx=tx, apply_fn=jmodel.apply)
    model = UNet(**TINY, **NO_DROPOUT, head=head)
    model.load_state_dict(convert.params_from_jax(jax.device_get(state.params), model),
                          strict=True)
    return state, model


def assert_matches_jax(model, state, loss, jloss):
    assert loss.dtype == torch.float32 and loss.ndim == 0
    assert abs(float(loss) - float(jloss)) <= LOSS_REL * abs(float(jloss))
    want = convert.params_from_jax(jax.device_get(state.params), model)
    for key, value in model.state_dict().items():
        assert rel_l2(value.numpy(), want[key].numpy()) <= PARAM_REL_L2, key


SEG_OBJECTIVES = {
    "dynamic": {},
    "static": {"static_weights": np.array([0.4, 1.3, 1.3], np.float32)},
    "unweighted": {"dynamic_weights": False},
}


@pytest.mark.parametrize("objective", list(SEG_OBJECTIVES))
def test_segmentation_accum_matches_jax(objective):
    kw = SEG_OBJECTIVES[objective]
    state, model = jax_and_port(seed=1)
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    jstep = jax_steps.make_accum_train_step(jax_steps.make_segmentation_loss_fn(**jkw), ACCUM,
                                            donate=False)
    step = steps.make_accum_train_step(model, train_state.sgd_nesterov(model.parameters()),
                                       steps.make_segmentation_loss_fn(**tkw), ACCUM)
    for seed in (2, 3):
        batch = seg_batch(seed)
        state, jloss = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()},
                             jax.random.key(0))
        loss = step(batch, torch.Generator().manual_seed(0))
        assert_matches_jax(model, state, loss, jloss)


RECON_OBJECTIVES = {"mse": {}, "composite": {"mse_weight": 0.7, "ssim_weight": 0.5}}


@pytest.mark.parametrize("objective", list(RECON_OBJECTIVES))
def test_reconstruction_accum_matches_jax(objective):
    kw = RECON_OBJECTIVES[objective]
    state, model = jax_and_port(head="reconstruction", seed=4)
    jstep = jax_steps.make_accum_train_step(jax_ae_recon.make_loss_fn(**kw), ACCUM,
                                            donate=False)
    step = steps.make_accum_train_step(
        model, train_state.sgd_nesterov(model.parameters()),
        steps.make_reconstruction_loss_fn(ae_recon.make_loss_fn(**kw)), ACCUM)
    for seed in (5, 6):
        batch = recon_batch(seed)
        state, jloss = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()},
                             jax.random.key(0))
        loss = step(batch, torch.Generator().manual_seed(0))
        assert_matches_jax(model, state, loss, jloss)


def twin_models(**kw):
    """Two port models with the same seeded weights (dropout on by
    default)."""
    return [UNet(**TINY, generator=torch.Generator().manual_seed(7), **kw) for _ in range(2)]


def test_accum_1_is_the_plain_step():
    a, b = twin_models()
    plain = steps.make_segmentation_train_step(a, train_state.sgd_nesterov(a.parameters()))
    accum = steps.make_accum_train_step(b, train_state.sgd_nesterov(b.parameters()),
                                        steps.make_segmentation_loss_fn(), 1)
    for seed in (8, 9):
        batch = seg_batch(seed)
        la = plain(batch, torch.Generator().manual_seed(seed))
        lb = accum(batch, torch.Generator().manual_seed(seed))
        assert torch.equal(la, lb)
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name


def test_strided_split_and_generators():
    """The step against the contract spelled out: microbatch i is
    ``batch[i::accum]`` (hand-built in numpy), its dropout generator
    ``microbatch_generator(generator, i)``, ``loss / accum`` backward, one
    update, the mean loss. Bit for bit, with dropout on."""
    accum = 4
    a, b = twin_models()
    loss_fn = steps.make_segmentation_loss_fn()
    seen = []

    def spy(model, batch, generator):
        seen.append(({k: v.clone() for k, v in batch.items()}, generator.initial_seed()))
        return loss_fn(model, batch, generator)

    step = steps.make_accum_train_step(a, train_state.sgd_nesterov(a.parameters()), spy, accum)
    batch = dict(seg_batch(10, n=8), index=np.arange(8))
    loss = step(batch, torch.Generator().manual_seed(11))

    optimizer = train_state.sgd_nesterov(b.parameters())
    gen = torch.Generator().manual_seed(11)
    b.train()
    optimizer.zero_grad()
    total = 0.0
    for i in range(accum):
        micro = {k: batch[k][i::accum] for k in ("image", "mask")}
        got, seed = seen[i]
        assert got.keys() == micro.keys()  # the index stays behind
        for k in micro:
            np.testing.assert_array_equal(got[k].numpy(), micro[k])
        mgen = steps.microbatch_generator(gen, i)
        assert seed == mgen.initial_seed()
        micro_loss = loss_fn(b, micro, mgen)
        (micro_loss / accum).backward()
        total = total + micro_loss.detach()
    optimizer.step()
    assert len({s for _, s in seen}) == accum
    assert torch.equal(loss, total / accum)
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name
    # The same step generator seeds the same microbatch generators (a resume
    # repeats the masks).
    assert steps.microbatch_generator(torch.Generator().manual_seed(11), 2).initial_seed() \
        == seen[2][1]


def test_indivisible_batch_and_bad_accum_raise():
    model = UNet(**TINY, **NO_DROPOUT)
    optimizer = train_state.sgd_nesterov(model.parameters())
    step = steps.make_accum_train_step(model, optimizer, steps.make_segmentation_loss_fn(), 3)
    with pytest.raises(ValueError, match="does not divide"):
        step(seg_batch(12), None)
    with pytest.raises(ValueError, match=">= 1"):
        steps.make_accum_train_step(model, optimizer, steps.make_segmentation_loss_fn(), 0)


def test_transfer_encoder_stays_frozen():
    """The transfer recipe's model: the encoder frozen by ``with_frozen`` and
    left out of the optimizer takes no gradient in any microbatch."""
    model = UNet(**TINY, generator=torch.Generator().manual_seed(13))
    frozen = encoder_param_names(model.n_stages)
    train_state.with_frozen(model, frozen)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    optimizer = train_state.sgd_nesterov([p for p in model.parameters() if p.requires_grad])
    step = steps.make_accum_train_step(model, optimizer, steps.make_segmentation_loss_fn(), 2)
    for seed in (14, 15):
        assert np.isfinite(float(step(seg_batch(seed), torch.Generator().manual_seed(seed))))
    for name, p in model.named_parameters():
        if name.startswith(tuple(f"{f}." for f in frozen)):
            assert p.grad is None and torch.equal(p.detach(), before[name]), name
        else:
            assert not torch.equal(p.detach(), before[name]), name
