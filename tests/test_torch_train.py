"""The port's training path (unet_implementations_tpu_torch) against JAX.

On the CPU every kernel wrapper runs its plain version, so these tests hold
the training arithmetic to the JAX package on the same numpy inputs:

- the backward of K1 (InstanceNorm+LeakyReLU) against ``jax.vjp`` of the
  JAX ``fused_instance_norm`` (its ``_bwd_impl``), float32 to 1e-5 relative;
- the backward of K2a/K2b (the 2x upsamples) against ``jax.vjp`` of the JAX
  ops (``jax.linear_transpose`` of the reference): float32 to 1e-6 of the
  largest magnitude, bfloat16 within one bf16 ulp;
- the losses and metrics, with masks holding the ignore label 255, to 1e-5
  relative, the confusion counts exactly;
- SGD-Nesterov and Adam-L2 updates against optax;
- two train steps of a 3-stage UNet (features 8-16-32, float32, dropout
  rates 0) in the dense and the s2d layout against JAX's
  ``make_segmentation_train_step``: the loss to 1e-5 relative, every
  parameter after each step to 1e-5 relative L2; and the eval step against
  JAX's.

The port's channel dropout draws from a torch generator, which JAX cannot
share, so it is tested on its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from unet_implementations_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from unet_implementations_tpu.kernels import instance_norm as jax_in
from unet_implementations_tpu.kernels import upsample as jax_up
from unet_implementations_tpu.models.unet import UNet as JaxUNet
from unet_implementations_tpu.ops import losses as jax_losses
from unet_implementations_tpu.ops import metrics as jax_metrics
from unet_implementations_tpu.training import steps as jax_steps
from unet_implementations_tpu.training import train_state as jax_ts
from unet_implementations_tpu_torch.data.synthetic import as_uint8, synthetic_batch
from unet_implementations_tpu_torch.kernels import instance_norm as torch_in
from unet_implementations_tpu_torch.kernels import upsample as torch_up
from unet_implementations_tpu_torch.models import convert
from unet_implementations_tpu_torch.models.blocks import ChannelDropout
from unet_implementations_tpu_torch.models.unet import S2D_LAYOUT, UNet
from unet_implementations_tpu_torch.ops import losses, metrics
from unet_implementations_tpu_torch.training import steps, train_state

TINY3 = dict(features_per_stage=(8, 16, 32), strides=(1, 2, 2),
             encoder_dropout_rates=(0.0, 0.0, 0.0), decoder_dropout_rates=(0.0, 0.0))
LAYOUTS = {"dense": {"s2d_level0": False, "s2d_low_channel_decoders": False}, "s2d": S2D_LAYOUT}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _bf16_ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    mag = np.maximum(np.abs(a), np.abs(b))
    exp = np.floor(np.log2(np.maximum(mag, np.float32(2.0 ** -126))))
    return np.abs(a - b) / np.exp2(exp - 7)


class TestInstanceNormBackward:
    @pytest.mark.parametrize("group", [1, 4])
    def test_matches_jax_vjp(self, group):
        rng = np.random.default_rng(group)
        x = (rng.normal(size=(2, 8, 8, 16)) * 2 + 0.5).astype(np.float32)
        c = 16 // group
        scale = (rng.normal(size=c) * 0.5 + 1.0).astype(np.float32)
        bias = (rng.normal(size=c) * 0.3).astype(np.float32)
        dy = rng.normal(size=x.shape).astype(np.float32)
        y_j, vjp = jax.vjp(lambda a, s, b: jax_in.fused_instance_norm(a, s, b, 1e-5, 0.01, group),
                           jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
        want = vjp(jnp.asarray(dy))
        xt, st, bt = (torch.from_numpy(v).requires_grad_() for v in (x, scale, bias))
        y_t = torch_in.fused_instance_norm(xt, st, bt, 1e-5, 0.01, group)
        y_t.backward(torch.from_numpy(dy))
        np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), rtol=1e-5, atol=1e-6)
        for got, w in zip((xt.grad, st.grad, bt.grad), want):
            assert got.dtype == torch.float32 and tuple(got.shape) == w.shape
            assert _rel(got.numpy(), w) <= 1e-5

    def test_bf16_dx_in_x_dtype(self):
        x = torch.randn(1, 4, 4, 8).to(torch.bfloat16).requires_grad_()
        s, b = torch.ones(8, requires_grad=True), torch.zeros(8, requires_grad=True)
        torch_in.fused_instance_norm(x, s, b).sum().backward()
        assert x.grad.dtype == torch.bfloat16 and s.grad.dtype == torch.float32

    def test_cpu_backward_counts_no_launch(self):
        x = torch.randn(1, 4, 4, 8, requires_grad=True)
        before = (torch_in.fused_instance_norm.launches,
                  torch_in.fused_instance_norm.backward_launches)
        torch_in.fused_instance_norm(x, torch.ones(8), torch.zeros(8)).sum().backward()
        assert (torch_in.fused_instance_norm.launches,
                torch_in.fused_instance_norm.backward_launches) == before


def _factored_backward(x, scale, bias, mean, rstd, dy, slope, group, chunk_px):
    """numpy rendering of the backward kernel's algebra
    (``csrc/instance_norm.cu``), summed in its order: per (image, piece of
    chunk_px pixels, channel) a row of partials of dpre and dpre·xhat, the
    row pooled over the group's q blocks (the block's sums); per image the
    rows added piece by piece, in order (the last block's pooling);
    m1 = scale·Σdpre / n and m2 = scale·Σ(dpre·xhat) / n;
    dx = (dpre·scale − m1 − xhat·m2)·rstd; dbias and dscale the pooled sums
    added over the images."""
    b, h, w, c = x.shape
    hw, cg = h * w, c // group
    xf = x.reshape(b, hw, c).astype(np.float32)
    g = dy.reshape(b, hw, c).astype(np.float32)
    s_full, b_full = np.tile(scale, group), np.tile(bias, group)
    xhat = (xf - mean[:, None]) * rstd[:, None]
    pre = xhat * s_full + b_full
    dpre = np.where(pre >= 0, g, g * np.float32(slope))
    nchunk = -(-hw // chunk_px)
    rows = np.zeros((b, nchunk, 2, cg), np.float32)
    for k in range(nchunk):
        part = slice(k * chunk_px, (k + 1) * chunk_px)
        rows[:, k, 0] = dpre[:, part].sum(1).reshape(b, group, cg).sum(1)
        rows[:, k, 1] = (dpre[:, part] * xhat[:, part]).sum(1).reshape(b, group, cg).sum(1)
    pooled = np.zeros((b, 2, cg), np.float32)  # q-major
    for k in range(nchunk):
        pooled += rows[:, k]
    n = np.float32(hw * group)
    m1 = np.tile(scale * pooled[:, 0] / n, group)  # (b, c)
    m2 = np.tile(scale * pooled[:, 1] / n, group)
    dx = (dpre * s_full - m1[:, None] - xhat * m2[:, None]) * rstd[:, None]
    return dx.reshape(x.shape), pooled[:, 1].sum(0), pooled[:, 0].sum(0)


# An H100 SXM: its SMs, and the shared memory a block may take after an
# opt-in (cudaDevAttrMaxSharedMemoryPerBlockOptin).
H100_SMS, H100_SMEM = 132, 232448
# The K1 shapes (side, C, group) of a b32 train step of unet_6stage at 512²:
# the six dense levels, and the s2d layout's group-4 norms (level 0 and
# decoder_3).
STEP_NORMS = [(512, 32, 1), (256, 64, 1), (128, 128, 1), (64, 256, 1), (32, 512, 1),
              (16, 512, 1), (256, 128, 4), (128, 256, 4)]


class TestInstanceNormBackwardKernel:
    """The CUDA backward's factored algebra (in numpy), and what its wrapper
    refuses; the kernel itself is held to ``_torch_backward`` on the card
    (``tests/test_torch_cuda.py``)."""

    @pytest.mark.parametrize("chunk_px", [None, 7, "plan"],
                             ids=["module-chunks", "7-pixel-chunks", "plan-pieces"])
    @pytest.mark.parametrize("group", [1, 4])
    def test_factored_matches_jax_bwd_impl(self, group, chunk_px):
        """The factored sums against JAX, with the pieces of the forward's
        chunking, of 7 pixels, and of ``bwd_plan`` on an H100 (an image the
        plan cuts into several pieces)."""
        rng = np.random.default_rng(10 + group)
        shape = (3, 40, 40, 16) if chunk_px == "plan" else (3, 6, 10, 16)
        x = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
        c = 16 // group
        scale = (rng.normal(size=c) * 0.5 + 1.0).astype(np.float32)
        bias = (rng.normal(size=c) * 0.3).astype(np.float32)
        dy = rng.normal(size=x.shape).astype(np.float32)
        _, mean, rstd = torch_in._torch_forward(torch.from_numpy(x), torch.from_numpy(scale),
                                                torch.from_numpy(bias), 1e-5, 0.01, group)
        mean, rstd = mean.numpy(), rstd.numpy()
        hw = shape[1] * shape[2]
        if chunk_px is None:
            chunk_px = torch_in.chunking(hw, 16, 4)[0]
        elif chunk_px == "plan":
            plan = torch_in.bwd_plan(3, hw, 16, group, 4, H100_SMS, H100_SMEM)
            assert plan.parts > 1
            chunk_px = plan.part_px
        got = _factored_backward(x, scale, bias, mean, rstd, dy, 0.01, group, chunk_px)
        want = jax_in._bwd_impl(1e-5, 0.01, group, tuple(jnp.asarray(v) for v in (
            x, scale, bias, mean, rstd)), jnp.asarray(dy))
        for g, w in zip(got, want):
            assert g.shape == w.shape
            assert _rel(g, w) <= 1e-5

    def test_refuses_what_the_kernel_does_not_take(self):
        x = torch.zeros(1, 4, 4, 8)
        s, b = torch.ones(8), torch.zeros(8)
        m, r = torch.zeros(1, 8), torch.ones(1, 8)
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            torch_in._cuda_backward(x.half(), s, b, m, r, x.half(), 0.01, 1)
        with pytest.raises(ValueError, match="dy must be"):
            torch_in._cuda_backward(x, s, b, m, r, torch.zeros(1, 4, 4, 4), 0.01, 1)
        with pytest.raises(ValueError, match="dy must be"):
            torch_in._cuda_backward(x, s, b, m, r, x.to(torch.bfloat16), 0.01, 1)
        with pytest.raises(ValueError, match="mean must be"):
            torch_in._cuda_backward(x, s, b, torch.zeros(8), r, x, 0.01, 1)
        with pytest.raises(ValueError, match="rstd must be"):
            torch_in._cuda_backward(x, s, b, m, r.double(), x, 0.01, 1)
        with pytest.raises(ValueError, match="C/group"):
            torch_in._cuda_backward(x, s, b, m, r, x, 0.01, 3)
        with pytest.raises(ValueError, match="C/group"):
            torch_in._cuda_backward(x, torch.ones(4), b, m, r, x, 0.01, 1)

    def test_profiling_kind_and_sources(self):
        """utils/profiling.py files K1bwd's kernels under a kind of their own,
        and sums the device time of each backward node and of the casts."""
        from types import SimpleNamespace

        from unet_implementations_tpu_torch.utils import profiling

        ns = "void unet::(anonymous namespace)::"
        for name in ("in_bwd_reduce_kernel<__nv_bfloat16, 8>(x)",
                     "in_bwd_apply_kernel<float, 4>(x)", "in_bwd_params_kernel(x)",
                     "in_bwd_fused_kernel<__nv_bfloat16, 8, true>(unet::(anonymous "
                     "namespace)::BwdArgs<__nv_bfloat16>)"):
            assert profiling.kind_of(ns + name) == "K1bwd instance norm backward"
        assert profiling.kind_of(ns + "in_apply_kernel<__nv_bfloat16, 8>(x)") == \
            "K1b instance norm apply"
        assert profiling.kind_of(ns + "in_stats_kernel<float, 4, true>(x)") == \
            "K1a instance norm statistics"

        events = [SimpleNamespace(key=profiling.NODE_PREFIX + "_Upsample2xBackward",
                                  device_time_total=3000.0),
                  SimpleNamespace(key=profiling.NODE_PREFIX + "_Upsample2xBackward",
                                  device_time_total=1000.0),
                  SimpleNamespace(key="aten::_to_copy", device_time_total=500.0),
                  SimpleNamespace(key="aten::mul", device_time_total=9000.0)]
        prof = SimpleNamespace(key_averages=lambda: events)
        assert profiling._by_source(prof, 2) == {"_Upsample2xBackward": 2.0,
                                                 "aten::_to_copy": 0.25}

    @pytest.mark.parametrize("hw,c,itemsize", [(512 * 512, 32, 2), (16 * 16, 512, 2),
                                               (7 * 9, 6, 4), (1, 8, 4), (1000, 3, 2)])
    def test_chunking_covers_the_image(self, hw, c, itemsize):
        chunk_px, nchunk = torch_in.chunking(hw, c, itemsize)
        assert chunk_px * nchunk >= hw > chunk_px * (nchunk - 1)
        assert nchunk <= torch_in._MAX_CHUNKS
        assert chunk_px * c * itemsize >= min(torch_in._MIN_CHUNK_BYTES, hw * c * itemsize)


def _pieces(plan, b, hw):
    """Every piece of the plan, block by block, in each block's order."""
    return [p for block in range(plan.grid) for p in torch_in.bwd_pieces(plan, b, hw, block)]


class TestBwdPlan:
    """``bwd_plan``, the backward kernel's cut of the work, on an H100."""

    # The step's shapes at b2, and shapes the card tests take: C not a
    # multiple of a vector, odd sizes, C/group not a multiple of a word.
    COVER = [(2, s * s, c, g) for s, c, g in STEP_NORMS] + [
        (2, 63, 6, 1), (2, 33 * 31, 24, 1), (1, 10000, 32, 1), (2, 400, 96, 4),
        (2, 400, 24, 4), (3, 1, 8, 1)]

    @pytest.mark.parametrize("itemsize", [2, 4])
    @pytest.mark.parametrize("b,hw,c,group", COVER)
    def test_covers_each_image_and_channel_once(self, b, hw, c, group, itemsize):
        """A fused plan's pieces cover every (image, pixel, channel) once, no
        block holds two pieces of one pair; a two-pass plan reads x and dy
        twice."""
        plan = torch_in.bwd_plan(b, hw, c, group, itemsize, H100_SMS, H100_SMEM)
        if not plan.fused:
            assert plan.reread_bytes == 2 * b * hw * c * itemsize
            return
        cg = c // group
        seen = np.zeros((b, hw, c), np.int32)
        pieces = _pieces(plan, b, hw)
        assert len(pieces) == plan.pieces and plan.grid <= H100_SMS and plan.reread_bytes == 0
        for img, j, part, p0, p1 in pieces:
            assert 0 <= p0 < p1 <= hw and p1 - p0 <= plan.part_px
            for q in range(group):
                seen[img, p0:p1, q * cg + j * plan.cs:q * cg + (j + 1) * plan.cs] += 1
        assert (seen == 1).all()
        for block in range(plan.grid):
            pairs = [(img, j) for img, j, *_ in torch_in.bwd_pieces(plan, b, hw, block)]
            assert len(pairs) == len(set(pairs))

    @pytest.mark.parametrize("itemsize", [2, 4])
    @pytest.mark.parametrize("side,c,group", STEP_NORMS)
    def test_slices_take_a_sector_of_every_q_block(self, side, c, group, itemsize):
        plan = torch_in.bwd_plan(32, side * side, c, group, itemsize, H100_SMS, H100_SMEM)
        assert plan.cs * itemsize >= 32 and (c // group) % plan.cs == 0
        assert plan.vec == 16 // itemsize and plan.cs % plan.vec == 0
        # A slice's pixel is its cs channels in each of the group's q blocks.
        assert plan.nv * plan.vec == group * plan.cs

    @pytest.mark.parametrize("itemsize", [2, 4])
    @pytest.mark.parametrize("b,hw,c,group", COVER + [(1, 1024 * 1024, 32, 1)])
    def test_shared_memory_fits_a_block(self, b, hw, c, group, itemsize):
        plan = torch_in.bwd_plan(b, hw, c, group, itemsize, H100_SMS, H100_SMEM)
        assert plan.smem + torch_in._BWD_SMEM_RESERVE <= H100_SMEM == 227 * 1024
        assert plan.threads == plan.rows * plan.nv <= torch_in._BWD_THREADS
        assert plan.threads % 32 == 0  # whole compute warps beside the role warps
        assert plan.ring_steps <= torch_in._MAX_RING_STEPS
        if plan.fused:
            assert 1 <= plan.steps <= plan.ring_steps

    @pytest.mark.parametrize("side,c,group", STEP_NORMS + [(100, 32, 1), (20, 96, 4)])
    def test_an_images_partition_does_not_depend_on_the_batch(self, side, c, group):
        one = torch_in.bwd_plan(1, side * side, c, group, 2, H100_SMS, H100_SMEM)
        many = torch_in.bwd_plan(32, side * side, c, group, 2, H100_SMS, H100_SMEM)
        assert one._replace(grid=0, pieces=0, reread_bytes=0) == many._replace(
            grid=0, pieces=0, reread_bytes=0)
        if one.fused:
            image0 = sorted(p for p in _pieces(many, 32, side * side) if p[0] == 0)
            assert image0 == sorted(_pieces(one, 1, side * side))

    @pytest.mark.parametrize("itemsize", [2, 4])
    @pytest.mark.parametrize("side,c,group", STEP_NORMS)
    def test_the_train_steps_shapes_dispatch(self, side, c, group, itemsize):
        """Levels 2-5 of a b32 step take the fused kernel, read once, each
        piece in its ring beside two more and a few steps loading; levels 0
        and 1 and the s2d norms, whose pairs spread over most of the card,
        take the two-pass kernel."""
        plan = torch_in.bwd_plan(32, side * side, c, group, itemsize, H100_SMS, H100_SMEM)
        if side >= 256 or group == 4:
            assert not plan.fused and plan.reread_bytes == 2 * 32 * side * side * c * itemsize
        else:
            assert plan.fused and plan.reread_bytes == 0
            assert plan.ring_steps >= 3 * plan.steps
            assert torch_in._PAIRS_A_ROUND * plan.parts <= H100_SMS

    def test_a_1024_float32_image_takes_the_two_pass_kernel(self):
        """A pair that would need more than the ring of every block."""
        plan = torch_in.bwd_plan(1, 1024 * 1024, 32, 1, 4, H100_SMS, H100_SMEM)
        assert not plan.fused and plan.steps > plan.ring_steps
        assert plan.reread_bytes == 2 * 1024 * 1024 * 32 * 4

    def test_refuses_what_no_block_holds(self):
        with pytest.raises(ValueError, match="no step"):
            torch_in.bwd_plan(1, 64, 32, 1, 2, H100_SMS, 16 * 1024)


class TestUpsampleBackward:
    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    @pytest.mark.parametrize("shape", [(2, 8, 8, 16), (2, 5, 7, 32), (1, 1, 3, 8)])
    @pytest.mark.parametrize("variant", ["dense", "s2d"])
    def test_matches_jax_vjp(self, dtype, shape, variant):
        jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
        jfn, tfn = {"dense": (jax_up.upsample2x_nhwc_fast, torch_up.upsample2x_nhwc_fast),
                    "s2d": (jax_up.upsample2x_into_s2d_fast,
                            torch_up.upsample2x_into_s2d_fast)}[variant]
        rng = np.random.default_rng(sum(shape))
        xj = jnp.asarray(rng.normal(size=shape), jdt)
        y, vjp = jax.vjp(jfn, xj)
        ct = jnp.asarray(rng.normal(size=y.shape), jdt)
        want = np.asarray(vjp(ct)[0].astype(jnp.float32))
        xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt).requires_grad_()
        yt = tfn(xt)
        assert tuple(yt.shape) == y.shape
        (got,) = torch.autograd.grad(yt, xt, torch.from_numpy(
            np.array(ct.astype(jnp.float32))).to(tdt))
        assert got.dtype == tdt
        got = got.to(torch.float32).numpy()
        if dtype == "f32":
            np.testing.assert_allclose(got / np.abs(want).max(), want / np.abs(want).max(),
                                       atol=1e-6)
        else:
            assert _bf16_ulps(got, want).max() <= 1.0


def _masks(seed, shape=(2, 16, 16)):
    """Integer masks over {0, 1, 2, 255}, and logits for them."""
    rng = np.random.default_rng(seed)
    mask = rng.choice([0, 1, 2, 255], size=shape, p=[0.4, 0.25, 0.2, 0.15]).astype(np.int32)
    logits = (rng.normal(size=(*shape, 3)) * 2).astype(np.float32)
    return logits, mask


class TestLosses:
    def test_class_weights(self):
        _, mask = _masks(0)
        got = losses.compute_class_weights(torch.from_numpy(mask))
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(jax_losses.compute_class_weights(mask)), rtol=1e-6)
        # A class absent from the batch: its count clamps to 1.
        mask[mask == 2] = 0
        got = losses.compute_class_weights(torch.from_numpy(mask))
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(jax_losses.compute_class_weights(mask)), rtol=1e-6)

    @pytest.mark.parametrize("weights", ["none", "static", "dynamic"])
    def test_cross_entropy(self, weights):
        logits, mask = _masks(1)
        w = {"none": None, "static": np.array([0.5, 1.2, 1.3], np.float32),
             "dynamic": np.asarray(jax_losses.compute_class_weights(mask))}[weights]
        want = jax_losses.weighted_cross_entropy(logits, mask, None if w is None else jnp.asarray(w))
        got = losses.weighted_cross_entropy(torch.from_numpy(logits), torch.from_numpy(mask),
                                            None if w is None else torch.from_numpy(w))
        assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))

    def test_dice(self):
        logits, mask = _masks(2)
        want = float(jax_losses.soft_dice_loss(logits, mask))
        got = float(losses.soft_dice_loss(torch.from_numpy(logits), torch.from_numpy(mask)))
        assert abs(got - want) <= 1e-5 * abs(want)

    @pytest.mark.parametrize("resize", [False, True])
    def test_segmentation_loss_and_grad(self, resize):
        logits, mask = _masks(3, (2, 16, 16))
        if resize:
            logits = logits[:, ::2, ::2]  # half size: resized to the mask
        want, gwant = jax.value_and_grad(
            lambda lg: jax_losses.segmentation_loss(lg, jnp.asarray(mask)))(jnp.asarray(logits))
        lt = torch.from_numpy(np.ascontiguousarray(logits)).requires_grad_()
        got = losses.segmentation_loss(lt, torch.from_numpy(mask))
        got.backward()
        assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))
        assert _rel(lt.grad.numpy(), gwant) <= 1e-5


class TestMetrics:
    def test_confusion_matrix_exact(self):
        rng = np.random.default_rng(4)
        pred = rng.integers(0, 3, (2, 16, 16)).astype(np.int32)
        _, mask = _masks(4)
        got = metrics.confusion_matrix(torch.from_numpy(pred), torch.from_numpy(mask))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jax_metrics.confusion_matrix(pred, mask)))

    def test_batch_dice_and_accumulator(self):
        rng = np.random.default_rng(5)
        pred = rng.integers(0, 3, (2, 16, 16)).astype(np.int32)
        _, mask = _masks(5)
        np.testing.assert_allclose(
            metrics.batch_dice_scores(torch.from_numpy(pred), torch.from_numpy(mask)).numpy(),
            np.asarray(jax_metrics.batch_dice_scores(pred, mask)), rtol=1e-6)
        # A class in neither pred nor mask scores 1.0.
        np.testing.assert_allclose(
            metrics.batch_dice_scores(torch.zeros(1, 4, 4, dtype=torch.int32),
                                      torch.zeros(1, 4, 4, dtype=torch.int32)).numpy(),
            np.asarray(jax_metrics.batch_dice_scores(np.zeros((1, 4, 4), np.int32),
                                                     np.zeros((1, 4, 4), np.int32))))
        ours, ref = metrics.SegmentationMetrics(3), jax_metrics.SegmentationMetrics(3)
        for p, t in ((pred, mask), (pred[:1], mask[:1])):
            ours.update(torch.from_numpy(p), t)
            ref.update(p, t)
        ours.update_confusion(metrics.confusion_matrix(torch.from_numpy(pred),
                                                       torch.from_numpy(mask)))
        ref.update_confusion(jax_metrics.confusion_matrix(pred, mask))
        np.testing.assert_array_equal(ours.cm, ref.cm)
        assert ours.get_all_metrics() == ref.get_all_metrics()
        for key, v in metrics.metrics_from_confusion(ours.cm).items():
            np.testing.assert_array_equal(v, jax_metrics.metrics_from_confusion(ref.cm)[key])
        for cls in range(3):
            assert metrics.compute_dice(pred, mask, cls) == jax_metrics.compute_dice(pred, mask, cls)
            assert metrics.compute_iou(pred, mask, cls) == jax_metrics.compute_iou(pred, mask, cls)
        assert (metrics.compute_pixel_accuracy(pred, mask)
                == jax_metrics.compute_pixel_accuracy(pred, mask))


class TestOptimizers:
    def _updates(self, make_torch, tx, steps=2):
        rng = np.random.default_rng(6)
        p0 = rng.normal(size=(5, 4)).astype(np.float32)
        grads = [rng.normal(size=(5, 4)).astype(np.float32) for _ in range(steps)]
        params = {"w": jnp.asarray(p0)}
        state = tx.init(params)
        pt = torch.nn.Parameter(torch.from_numpy(p0.copy()))
        opt = make_torch([pt])
        for g in grads:
            updates, state = tx.update({"w": jnp.asarray(g)}, state, params)
            params = optax.apply_updates(params, updates)
            pt.grad = torch.from_numpy(g)
            opt.step()
            np.testing.assert_allclose(pt.detach().numpy(), np.asarray(params["w"]), rtol=1e-6,
                                       atol=1e-7)

    def test_sgd_nesterov_matches_optax(self):
        self._updates(train_state.sgd_nesterov, jax_ts.sgd_nesterov())

    def test_adam_l2_matches_optax(self):
        self._updates(train_state.adam_l2, jax_ts.adam_l2(), steps=3)

    def test_schedules_and_learning_rate(self):
        for epoch in (0, 3, 9):
            assert train_state.poly_lr(5e-3, 10)(epoch) == jax_ts.poly_lr(5e-3, 10)(epoch)
            assert train_state.cosine_lr(1e-3, 10)(epoch) == jax_ts.cosine_lr(1e-3, 10)(epoch)
        opt = train_state.sgd_nesterov([torch.nn.Parameter(torch.zeros(2))])
        assert train_state.get_learning_rate(opt) == 5e-3
        train_state.set_learning_rate(opt, 1e-3)
        assert train_state.get_learning_rate(opt) == 1e-3

    def test_with_frozen_leaves_the_encoder(self):
        model = UNet(**TINY3)
        train_state.with_frozen(model, ["encoder_stages"])
        opt = train_state.sgd_nesterov(model.parameters())
        before = {k: v.clone() for k, v in model.state_dict().items()}
        x = torch.randn(1, 16, 16, 3)
        model(x).sum().backward()
        opt.step()
        for k, v in model.state_dict().items():
            assert torch.equal(v, before[k]) == k.startswith("encoder_stages"), k


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


def _jax_and_port_training(layout, seed, size=32):
    flags = LAYOUTS[layout]
    jmodel = JaxUNet(**TINY3, **flags)
    batch = as_uint8(synthetic_batch(seed, 2, size))
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0),
                            jnp.zeros((2, size, size, 3), jnp.float32))["params"]
    params = jax.tree.map(jnp.asarray, _seeded_params(shapes, np.random.default_rng(seed)))
    tx = jax_ts.sgd_nesterov()
    state = jax_ts.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                              opt_state=tx.init(params), tx=tx, apply_fn=jmodel.apply)
    model = UNet(**TINY3, **flags)
    model.load_state_dict(convert.params_from_jax(params, model), strict=True)
    return jmodel, state, model, batch


class TestTrainStep:
    @pytest.mark.parametrize("layout", ["dense", "s2d"])
    def test_two_steps_match_jax(self, layout):
        jmodel, state, model, batch = _jax_and_port_training(layout, seed=11)
        jstep = jax_steps.make_segmentation_train_step(donate=False)
        step = steps.make_segmentation_train_step(model, train_state.sgd_nesterov(
            model.parameters()))
        batches = [batch, as_uint8(synthetic_batch(12, 2, 32))]
        for b in batches:
            state, jloss = jstep(state, {k: jnp.asarray(v) for k, v in b.items()},
                                 jax.random.key(0))
            loss = step(b, torch.Generator().manual_seed(0))
            assert loss.dtype == torch.float32 and loss.ndim == 0
            assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
            want = convert.params_from_jax(jax.device_get(state.params), model)
            for key, value in model.state_dict().items():
                assert _rel(value.numpy(), want[key].numpy()) <= 1e-5, key

    @pytest.mark.parametrize("layout", ["dense", "s2d"])
    def test_eval_step_matches_jax(self, layout):
        jmodel, state, model, batch = _jax_and_port_training(layout, seed=13)
        want = jax_steps.make_segmentation_eval_step()(
            state, {k: jnp.asarray(v) for k, v in batch.items()})
        got = steps.make_segmentation_eval_step(model)(batch)
        assert not model.training
        assert abs(float(got["loss"]) - float(want["loss"])) <= 1e-5 * abs(float(want["loss"]))
        np.testing.assert_allclose(got["dice"].numpy(), np.asarray(want["dice"]), rtol=1e-5)
        assert got["preds"].dtype == torch.int32
        np.testing.assert_array_equal(got["preds"].numpy(), np.asarray(want["preds"]))
        np.testing.assert_array_equal(got["confusion"].numpy(), np.asarray(want["confusion"]))

    def test_train_step_after_an_eval_step(self):
        """The s2d convs' kernel indices, cached by a first call under
        ``torch.inference_mode`` (an eval step), serve a later train step."""
        model = UNet(**TINY3, **S2D_LAYOUT)
        batch = as_uint8(synthetic_batch(14, 2, 32))
        steps.make_segmentation_eval_step(model)(batch)
        step = steps.make_segmentation_train_step(model, train_state.sgd_nesterov(
            model.parameters()))
        assert np.isfinite(float(step(batch, torch.Generator().manual_seed(0))))

    def test_synthetic_batch_is_the_jax_one(self):
        ours, ref = synthetic_batch(3, 2, 24), jax_synthetic_batch(3, 2, 24)
        assert ours.keys() == ref.keys()
        for k in ours:
            np.testing.assert_array_equal(ours[k], ref[k])
        pixels = as_uint8(ours)["image"]
        assert pixels.dtype == np.uint8 and pixels.shape == (2, 24, 24, 3)


class TestChannelDropout:
    """Port-only: whole channels drop, the rest scale by 1/(1-p), from a seed."""

    def _x(self, c=16, b=3):
        return torch.randn(b, c, 6, 5).contiguous(memory_format=torch.channels_last)

    @pytest.mark.parametrize("group", [1, 4])
    def test_whole_channels_and_seeded(self, group):
        drop = ChannelDropout(0.5).train()
        x = self._x()
        y = drop(x, torch.Generator().manual_seed(1), group)
        kept = (y != 0).reshape(3, 16, -1)
        assert bool((kept.all(-1) | ~kept.any(-1)).all())  # all or nothing per channel
        ch = kept.all(-1)
        torch.testing.assert_close(y[ch], x[ch] / 0.5)
        if group == 4:  # the 4 q blocks of an original channel drop together
            q = ch.reshape(3, 4, 4)
            assert bool((q == q[:, :1]).all())
        assert torch.equal(y, drop(x, torch.Generator().manual_seed(1), group))
        assert not torch.equal(y, drop(x, torch.Generator().manual_seed(2), group))
        assert 0 < int(ch.sum()) < ch.numel()

    def test_eval_and_generator_rules(self):
        drop = ChannelDropout(0.3)
        x = self._x()
        assert drop.eval()(x, None) is x
        with pytest.raises(ValueError, match="Generator"):
            drop.train()(x, None)
        model = UNet(features_per_stage=(4, 8), strides=(1, 2), encoder_dropout_rates=(0.0, 0.2),
                     decoder_dropout_rates=(0.1,)).train()
        with pytest.raises(ValueError, match="Generator"):
            model(torch.randn(1, 8, 8, 3))
        a = model(torch.randn(1, 8, 8, 3), generator=torch.Generator().manual_seed(0))
        assert a.shape == (1, 8, 8, 3)
