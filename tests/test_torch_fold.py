"""The port's decoder upsample folds (``ops/s2d.py``) against JAX's
``models/s2d.py`` and its dispatch (``models/blocks.py::UpBlock``), on the
CPU, each input made from a seed with numpy and given to both packages.

- ``fold_up_kernel``: float32 to 1e-6, bfloat16 within one bf16 ulp (the
  kernel cast to bf16 first, as JAX's ``ConvOp`` does);
- ``conv_up_fold`` at the four shapes of JAX's ``TestConvUpFold``,
  ``conv_s2d_multi_up_fold`` and ``conv_dense_up_fold`` at
  ``tests/test_up_fold.py``'s tolerances (atol 2e-5, rtol 1e-4), and on row
  shards (``RowShard``) against the unsharded fold;
- the gradients of sum(y²) in x and in the kernel (atol 2e-4, rtol 1e-3);
- the tiny-grid refusal and the small-grid unfolded path;
- the two policies over ``tests/test_policy_matrix.py``'s environment cases,
  against JAX's with its backend reported as the CPU;
- ``UpBlock`` with each fold on and off, in both layouts, against JAX's;
- the full-width ``unet_6stage`` at 64² with the s2d fold on, in both
  layouts, against JAX's folded forward (rel-L2 1e-4), its state dict the
  one JAX's parameters convert to;
- a 32² train step with each fold forced on against JAX's step (the loss to
  1e-5 relative, each parameter to 1e-5 relative L2, as
  ``tests/test_torch_train.py``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_implementations_tpu.models import blocks as jax_blocks
from unet_implementations_tpu.models import s2d as jax_s2d
from unet_implementations_tpu.models.unet import UNet as JaxUNet
from unet_implementations_tpu.models.unet import unet_6stage as jax_unet_6stage
from unet_implementations_tpu.training import steps as jax_steps
from unet_implementations_tpu.training import train_state as jax_ts
from unet_implementations_tpu_torch.data.synthetic import as_uint8, synthetic_batch
from unet_implementations_tpu_torch.models import blocks, convert
from unet_implementations_tpu_torch.models.blocks import UpBlock
from unet_implementations_tpu_torch.models.unet import S2D_LAYOUT, UNet
from unet_implementations_tpu_torch.ops import s2d
from unet_implementations_tpu_torch.training import steps, train_state

FOLD_VARS = ("UNET_TPU_S2D_UP_FOLD", "UNET_TPU_DENSE_UP_FOLD")
ATOL, RTOL = 2e-5, 1e-4
GRAD_ATOL, GRAD_RTOL = 2e-4, 1e-3
MODEL_REL_L2 = 1e-4
LAYOUTS = {"dense": {"s2d_level0": False, "s2d_low_channel_decoders": False}, "s2d": S2D_LAYOUT}


@pytest.fixture
def clean_env(monkeypatch):
    for var in FOLD_VARS:
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


def _oihw(k: np.ndarray) -> torch.Tensor:
    """A JAX HWIO kernel as torch's OIHW."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1))))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _bf16_ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    mag = np.maximum(np.maximum(np.abs(a), np.abs(b)), np.float32(2.0 ** -126))
    return np.abs(a - b) / np.exp2(np.floor(np.log2(mag)) - 7)


class TestFoldKernel:
    def test_float32(self):
        k = np.random.default_rng(1).standard_normal((3, 3, 6, 5)).astype(np.float32)
        want = np.asarray(jax_s2d.fold_up_kernel(jnp.asarray(k)))  # (3, 3, Cin, 4Cout)
        got = s2d.fold_up_kernel(_oihw(k))
        assert tuple(got.shape) == (20, 6, 3, 3) and got.dtype == torch.float32
        np.testing.assert_allclose(got.permute(2, 3, 1, 0).numpy(), want, rtol=0, atol=1e-6)

    def test_bfloat16_within_one_ulp(self):
        k = np.random.default_rng(2).standard_normal((3, 3, 8, 4)).astype(np.float32)
        want = np.asarray(jax_s2d.fold_up_kernel(jnp.asarray(k, jnp.bfloat16)).astype(jnp.float32))
        got = s2d.fold_up_kernel(_oihw(k).to(torch.bfloat16))
        assert got.dtype == torch.bfloat16
        assert _bf16_ulps(got.float().permute(2, 3, 1, 0).numpy(), want).max() <= 1.0

    def test_q_major_layout(self):
        """Output channel (oy·2 + ox)·Cout + o: the fold of a kernel that is
        one tap of one (o, c) pair lands in o's four q blocks only."""
        k = torch.zeros(3, 2, 3, 3)
        k[1, 0, 1, 1] = 1.0
        kf = s2d.fold_up_kernel(k)
        nonzero = sorted({int(i) for i in torch.nonzero(kf)[:, 0]})
        assert nonzero == [1, 4, 7, 10]
        assert torch.equal(kf[:, 1], torch.zeros(12, 3, 3))

    def test_refuses_other_sizes(self):
        with pytest.raises(ValueError, match="3x3"):
            s2d.fold_up_kernel(torch.zeros(2, 2, 5, 5))


def _fold_inputs(shape, seed):
    b, h, w, cin, cout = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    k = (rng.standard_normal((3, 3, cin, cout)) * 0.1).astype(np.float32)
    return x, k


class TestConvUpFold:
    @pytest.mark.parametrize("shape", [(2, 8, 8, 8, 16), (1, 12, 16, 4, 4),
                                       (2, 16, 8, 8, 8), (1, 6, 6, 3, 5)])
    def test_matches_jax(self, shape):
        x, k = _fold_inputs(shape, shape[1] * shape[2])
        want = np.asarray(jax_s2d.conv_up_fold(jnp.asarray(x), jnp.asarray(k)))
        got = s2d.conv_up_fold(torch.from_numpy(x), _oihw(k))
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)

    @pytest.mark.parametrize("h,n_shards", [(8, 2), (8, 4), (4, 4)])
    def test_row_shards_are_the_unsharded_rows(self, h, n_shards):
        """Each shard with one neighbour row beyond each inner edge gives the
        unsharded fold's rows, down to shards of one row."""
        x, k = _fold_inputs((2, h, 6, 4, 3), h + n_shards)
        step = h // n_shards
        want = s2d.conv_up_fold(torch.from_numpy(x), _oihw(k))
        rows = []
        for i in range(n_shards):
            lo, hi = max(i * step - 1, 0), min((i + 1) * step + 1, h)
            shard = s2d.RowShard(h, i == 0, i == n_shards - 1)
            rows.append(s2d.conv_up_fold(torch.from_numpy(x[:, lo:hi]), _oihw(k), shard))
        np.testing.assert_allclose(torch.cat(rows, dim=1).numpy(), want.numpy(), atol=1e-6,
                                   rtol=1e-6)

    def test_multi_matches_jax(self):
        rng = np.random.default_rng(7)
        x = rng.standard_normal((2, 8, 8, 8)).astype(np.float32)
        skip = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
        k = (rng.standard_normal((3, 3, 12, 4)) * 0.1).astype(np.float32)
        bias = rng.standard_normal(4).astype(np.float32)
        want = np.asarray(jax_s2d.conv_s2d_multi_up_fold(
            jnp.asarray(x), [jnp.asarray(skip)], jnp.asarray(k), jnp.asarray(bias), (8, 4)))
        got = s2d.conv_s2d_multi_up_fold(torch.from_numpy(x), [torch.from_numpy(skip)], _oihw(k),
                                         torch.from_numpy(bias), (8, 4))
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
        # And the unfolded composite of the port.
        up = s2d.upsample2x_into_s2d(torch.from_numpy(x))
        composite = s2d.conv_s2d_multi([up, torch.from_numpy(skip)], _oihw(k),
                                       torch.from_numpy(bias), (8, 4))
        np.testing.assert_allclose(got.numpy(), composite.numpy(), atol=ATOL, rtol=RTOL)

    @pytest.mark.parametrize("shape", [(2, 8, 8, 8, 16, 4), (1, 3, 5, 4, 4, 8),
                                       (2, 16, 8, 8, 8, 8), (1, 6, 6, 3, 5, 2)])
    def test_dense_matches_jax(self, shape):
        b, h, w, cin, cskip, cout = shape
        rng = np.random.default_rng(h * w + cin)
        x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
        skip = rng.standard_normal((b, 2 * h, 2 * w, cskip)).astype(np.float32)
        k = (rng.standard_normal((3, 3, cin + cskip, cout)) * 0.1).astype(np.float32)
        bias = rng.standard_normal(cout).astype(np.float32)
        want = np.asarray(jax_s2d.conv_dense_up_fold(
            jnp.asarray(x), [jnp.asarray(skip)], jnp.asarray(k), jnp.asarray(bias)))
        got = s2d.conv_dense_up_fold(torch.from_numpy(x), [torch.from_numpy(skip)], _oihw(k),
                                     torch.from_numpy(bias))
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)

    def test_gradients_match_jax(self):
        rng = np.random.default_rng(3)
        x = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
        k = (rng.standard_normal((3, 3, 4, 4)) * 0.1).astype(np.float32)
        gk, gx = jax.jit(jax.grad(lambda k, x: jnp.sum(jax_s2d.conv_up_fold(x, k) ** 2),
                                  argnums=(0, 1)))(jnp.asarray(k), jnp.asarray(x))
        xt, kt = torch.from_numpy(x).requires_grad_(True), _oihw(k).requires_grad_(True)
        (s2d.conv_up_fold(xt, kt) ** 2).sum().backward()
        np.testing.assert_allclose(kt.grad.permute(2, 3, 1, 0).numpy(), np.asarray(gk),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL)
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL)

    def test_dense_gradients_match_jax(self):
        rng = np.random.default_rng(11)
        x = rng.standard_normal((1, 6, 6, 4)).astype(np.float32)
        skip = rng.standard_normal((1, 12, 12, 3)).astype(np.float32)
        k = (rng.standard_normal((3, 3, 7, 4)) * 0.1).astype(np.float32)
        bias = np.zeros(4, np.float32)

        def loss(k, x):
            return jnp.sum(jax_s2d.conv_dense_up_fold(x, [jnp.asarray(skip)], k,
                                                      jnp.asarray(bias)) ** 2)

        gk, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(k), jnp.asarray(x))
        xt, kt = torch.from_numpy(x).requires_grad_(True), _oihw(k).requires_grad_(True)
        y = s2d.conv_dense_up_fold(xt, [torch.from_numpy(skip)], kt, torch.from_numpy(bias))
        (y ** 2).sum().backward()
        np.testing.assert_allclose(kt.grad.permute(2, 3, 1, 0).numpy(), np.asarray(gk),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL)
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL)

    def test_rejects_tiny_grids(self):
        with pytest.raises(ValueError, match=">=3x3 coarse grid"):
            s2d.conv_up_fold(torch.zeros(1, 2, 2, 4), torch.zeros(4, 4, 3, 3))
        with pytest.raises(ValueError, match=">=3x3 coarse grid"):
            s2d.conv_up_fold(torch.zeros(1, 2, 8, 4), torch.zeros(4, 4, 3, 3),
                             s2d.RowShard(2, True, False))


# tests/test_policy_matrix.py's environment cases, and the parsing of values.
POLICY_ENVS = [
    {}, {"UNET_TPU_S2D_UP_FOLD": "0"}, {"UNET_TPU_S2D_UP_FOLD": "1"},
    {"UNET_TPU_S2D_UP_FOLD": "false"}, {"UNET_TPU_S2D_UP_FOLD": ""},
    {"UNET_TPU_S2D_UP_FOLD": "0", "UNET_TPU_DENSE_UP_FOLD": "1"},
    {"UNET_TPU_S2D_UP_FOLD": "0", "UNET_TPU_DENSE_UP_FOLD": "0"},
    {"UNET_TPU_DENSE_UP_FOLD": "1"}, {"UNET_TPU_DENSE_UP_FOLD": "true"},
    {"UNET_TPU_S2D_UP_FOLD": "1", "UNET_TPU_DENSE_UP_FOLD": "0"},
    {"UNET_TPU_S2D_UP_FOLD": "1", "UNET_TPU_DENSE_UP_FOLD": ""},
]


@pytest.mark.parametrize("env", POLICY_ENVS, ids=lambda e: ",".join(
    f"{k.split('_')[2]}={v!r}" for k, v in e.items()) or "unset")
def test_policies_match_jax_off_the_tpu(clean_env, env):
    clean_env.setattr(jax, "default_backend", lambda: "cpu")
    for k, v in env.items():
        clean_env.setenv(k, v)

    def resolve(mod):
        return (mod.up_fold_enabled(), mod.dense_up_fold_enabled(True),
                mod.dense_up_fold_enabled(False), mod.dense_up_fold_enabled())

    assert resolve(s2d) == resolve(jax_s2d)
    if not env:
        assert resolve(s2d) == (False,) * 4


def _upblock_state(params) -> dict:
    """JAX ``UpBlock`` parameters as the port's ``UpBlock`` state dict."""
    cb = params["conv_block"]
    sd = {}
    for i in range(2):
        conv, norm = cb[f"conv_{i}"], cb[f"norm_{i}"]
        sd[f"conv_block.block.{3 * i}.weight"] = _oihw(np.asarray(conv["kernel"]))
        sd[f"conv_block.block.{3 * i}.bias"] = torch.from_numpy(np.asarray(conv["bias"]))
        sd[f"conv_block.block.{3 * i + 1}.weight"] = torch.from_numpy(np.asarray(norm["scale"]))
        sd[f"conv_block.block.{3 * i + 1}.bias"] = torch.from_numpy(np.asarray(norm["bias"]))
    return sd


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def _spy(monkeypatch, name: str, calls=None) -> list:
    """Record each call of ``blocks.<name>`` in ``calls`` (a new list)."""
    calls = [] if calls is None else calls
    real = getattr(blocks, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return real(*args, **kwargs)

    monkeypatch.setattr(blocks, name, spy)
    return calls


# (layout, x shape, skip shape, cin of the block's conv_0 besides the skip).
UPBLOCKS = {"dense": ((2, 8, 8, 12), (2, 16, 16, 6)), "s2d": ((1, 6, 6, 8), (1, 6, 6, 16))}
FOLD_ENV = {"dense": "UNET_TPU_DENSE_UP_FOLD", "s2d": "UNET_TPU_S2D_UP_FOLD"}
FOLD_FN = {"dense": "conv_dense_up_fold", "s2d": "conv_s2d_multi_up_fold"}


@pytest.mark.parametrize("layout", ["dense", "s2d"])
@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
def test_upblock_fold_on_and_off(clean_env, layout, training):
    x_shape, skip_shape = UPBLOCKS[layout]
    rng = np.random.default_rng(5)
    x = rng.standard_normal(x_shape).astype(np.float32)
    skip = rng.standard_normal(skip_shape).astype(np.float32)
    is_s2d = layout == "s2d"
    jblock = jax_blocks.UpBlock(features=8, dtype=jnp.float32, s2d=is_s2d)
    params = jblock.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(skip))["params"]
    skip_c = skip_shape[-1] // (4 if is_s2d else 1)
    block = UpBlock(x_shape[-1], skip_c, 8).train(training)
    block.load_state_dict(_upblock_state(params), strict=True)
    folds = _spy(clean_env, FOLD_FN[layout])
    outs = {}
    for fold in ("0", "1"):
        clean_env.setenv(FOLD_ENV[layout], fold)
        # JAX reads the policy while it traces: a new function each time.
        want = np.asarray(jax.jit(lambda p, x, s: jblock.apply(
            {"params": p}, x, s, deterministic=not training))(params, jnp.asarray(x),
                                                             jnp.asarray(skip)))
        got = block(_nchw(x), _nchw(skip), s2d=is_s2d).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.detach().numpy(), want, atol=5e-5, rtol=1e-4)
        outs[fold] = got.detach().numpy()
    assert folds == [FOLD_FN[layout]]  # the fold ran once: with its variable at 1
    np.testing.assert_allclose(outs["1"], outs["0"], atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("layout", ["dense", "s2d"])
def test_small_coarse_grid_runs_unfolded(clean_env, layout):
    """A 2×2 coarse grid cannot take the strips: with the fold forced on the
    block upsamples as with it off, bit for bit, and JAX agrees."""
    is_s2d = layout == "s2d"
    rng = np.random.default_rng(9)
    x = rng.standard_normal((1, 2, 2, 4)).astype(np.float32)
    skip = rng.standard_normal((1, 2, 2, 16) if is_s2d else (1, 4, 4, 4)).astype(np.float32)
    jblock = jax_blocks.UpBlock(features=4, dtype=jnp.float32, s2d=is_s2d)
    params = jblock.init(jax.random.key(1), jnp.asarray(x), jnp.asarray(skip))["params"]
    block = UpBlock(4, 4, 4).eval()
    block.load_state_dict(_upblock_state(params), strict=True)
    folds = _spy(clean_env, FOLD_FN[layout])
    with torch.no_grad():
        off = block(_nchw(x), _nchw(skip), s2d=is_s2d)
        clean_env.setenv(FOLD_ENV[layout], "1")
        on = block(_nchw(x), _nchw(skip), s2d=is_s2d)
    want = np.asarray(jblock.apply({"params": params}, jnp.asarray(x), jnp.asarray(skip)))
    assert folds == [] and torch.equal(on, off)
    np.testing.assert_allclose(on.permute(0, 2, 3, 1).numpy(), want, atol=1e-6, rtol=1e-6)


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


@pytest.fixture(scope="module")
def full_width():
    """``unet_6stage``'s JAX parameters (seeded with numpy) at 64², an input,
    and JAX's forward with the s2d fold on (JAX's default layout, s2d)."""
    jmodel = jax_unet_6stage(dtype=jnp.float32)
    rng = np.random.default_rng(23)
    x = rng.normal(size=(1, 64, 64, 3)).astype(np.float32)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.asarray(x))["params"]
    params = _seeded_params(shapes, rng)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("UNET_TPU_S2D_UP_FOLD", "1")
        want = np.asarray(jax.jit(lambda p, x: jmodel.apply({"params": p}, x))(
            params, jnp.asarray(x)))
    return params, x, want


@pytest.mark.parametrize("layout", ["dense", "s2d"])
def test_unet_6stage_fold_matches_jax(clean_env, full_width, layout):
    params, x, want = full_width
    model = UNet(**LAYOUTS[layout]).eval()
    sd = convert.params_from_jax(params, model)
    model.load_state_dict(sd, strict=True)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    folds = _spy(clean_env, "conv_dense_up_fold", _spy(clean_env, "conv_s2d_multi_up_fold"))
    clean_env.setenv("UNET_TPU_S2D_UP_FOLD", "1")
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    # decoder_0's 2×2 coarse grid runs unfolded; the other four fold (the
    # dense fold follows the s2d policy in eval mode).
    assert len(folds) == 4 and got.shape == want.shape
    assert _rel(got, want) <= MODEL_REL_L2, _rel(got, want)
    after = model.state_dict()
    assert after.keys() == sd.keys() and all(torch.equal(after[k], before[k]) for k in after)


TINY3 = dict(features_per_stage=(8, 16, 32), strides=(1, 2, 2),
             encoder_dropout_rates=(0.0, 0.0, 0.0), decoder_dropout_rates=(0.0, 0.0))


@pytest.mark.parametrize("layout,var", [("s2d", "UNET_TPU_S2D_UP_FOLD"),
                                        ("dense", "UNET_TPU_DENSE_UP_FOLD")])
def test_train_step_with_the_fold_matches_jax(clean_env, layout, var):
    """One 32² step of a 3-stage UNet with the fold on in training: in s2d the
    s2d decoder folds (``UNET_TPU_S2D_UP_FOLD=1``), dense both decoders
    (``UNET_TPU_DENSE_UP_FOLD=1``), through autograd of the folds."""
    clean_env.setenv(var, "1")
    flags = LAYOUTS[layout]
    jmodel = JaxUNet(**TINY3, **flags)
    batch = as_uint8(synthetic_batch(17, 2, 32))
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0),
                            jnp.zeros((2, 32, 32, 3), jnp.float32))["params"]
    params = jax.tree.map(jnp.asarray, _seeded_params(shapes, np.random.default_rng(17)))
    tx = jax_ts.sgd_nesterov()
    state = jax_ts.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                              opt_state=tx.init(params), tx=tx, apply_fn=jmodel.apply)
    model = UNet(**TINY3, **flags)
    model.load_state_dict(convert.params_from_jax(params, model), strict=True)
    folds = _spy(clean_env, FOLD_FN[layout])
    state, jloss = jax_steps.make_segmentation_train_step(donate=False)(
        state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(0))
    loss = steps.make_segmentation_train_step(model, train_state.sgd_nesterov(
        model.parameters()))(batch, torch.Generator().manual_seed(0))
    assert len(folds) == (1 if layout == "s2d" else 2)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = convert.params_from_jax(jax.device_get(state.params), model)
    for key, value in model.state_dict().items():
        assert _rel(value.numpy(), want[key].numpy()) <= 1e-5, key
