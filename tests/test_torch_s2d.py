"""The port's space-to-depth layout algebra (unet_implementations_tpu_torch/
ops/s2d.py) against ``unet_implementations_tpu/models/s2d.py``.

Inputs come from numpy with a seed. Tolerances: the rearrangements and the
kernel transforms are bitwise (after HWIO -> OIHW), the transforms' backward
to 1e-6 (it sums 4 positions per element); the convs and the norm
agree with JAX to 1e-5 in float32 (both run highest-precision float32 convs
on the CPU, in other summation orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from unet_implementations_tpu.models import s2d as jax_s2d
from unet_implementations_tpu_torch.ops import s2d

TOL = dict(rtol=1e-5, atol=1e-5)


def _oihw(k_hwio: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(k_hwio, (3, 2, 0, 1))))


def _hwio(k_oihw: torch.Tensor) -> np.ndarray:
    return np.transpose(k_oihw.numpy(), (2, 3, 1, 0))


def _rand(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


class TestLayout:
    @pytest.mark.parametrize("shape", [(2, 8, 12, 3), (1, 16, 16, 8)])
    def test_space_to_depth_bitwise(self, shape):
        x = _rand(0, *shape)
        got = s2d.space_to_depth(torch.from_numpy(x))
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax_s2d.space_to_depth(x)))
        back = s2d.depth_to_space(got)
        np.testing.assert_array_equal(
            back.numpy(), np.asarray(jax_s2d.depth_to_space(jax_s2d.space_to_depth(x))))
        np.testing.assert_array_equal(back.numpy(), x)

    def test_upsample_into_s2d_is_s2d_of_upsample(self):
        from unet_implementations_tpu_torch.ops.resize import upsample2x_nhwc

        x = torch.from_numpy(_rand(1, 2, 6, 5, 4))
        np.testing.assert_array_equal(s2d.upsample2x_into_s2d(x).numpy(),
                                      s2d.space_to_depth(upsample2x_nhwc(x)).numpy())


class TestKernelTransforms:
    @pytest.mark.parametrize("k,cin,cout,segments", [
        (3, 6, 4, None), (1, 5, 3, None), (3, 6, 4, (4, 2)), (3, 7, 2, (2, 3, 2))])
    def test_transform_kernel_bitwise(self, k, cin, cout, segments):
        kernel = _rand(k + cin, k, k, cin, cout)
        want = np.asarray(jax_s2d.transform_kernel(jnp.asarray(kernel), segments))
        got = s2d.transform_kernel(_oihw(kernel), segments)
        assert tuple(got.shape) == (4 * cout, 4 * cin, want.shape[0], want.shape[1])
        np.testing.assert_array_equal(_hwio(got), want)

    def test_transform_kernel_stride2_bitwise(self):
        kernel = _rand(3, 3, 3, 5, 6)
        want = np.asarray(jax_s2d.transform_kernel_stride2(jnp.asarray(kernel)))
        got = s2d.transform_kernel_stride2(_oihw(kernel))
        assert tuple(got.shape) == (6, 20, 2, 2)
        np.testing.assert_array_equal(_hwio(got), want)

    def test_transform_keeps_bf16_values(self):
        kernel = _oihw(_rand(4, 3, 3, 4, 4)).to(torch.bfloat16)
        got = s2d.transform_kernel(kernel)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got.unique(), torch.cat([kernel.flatten(), kernel.new_zeros(1)]).unique())

    @pytest.mark.parametrize("k,segments,stride2", [
        (3, None, False), (1, None, False), (3, (4, 2), False), (3, None, True)])
    def test_transform_grad_matches_jax(self, k, segments, stride2):
        """The transforms' backward (a gather through the inverse index) is
        the transpose JAX takes of its own transforms."""
        kernel = _rand(11, k, k, 6, 4)
        fn_j = (jax_s2d.transform_kernel_stride2 if stride2
                else lambda w: jax_s2d.transform_kernel(w, segments))
        fn_t = (s2d.transform_kernel_stride2 if stride2
                else lambda w: s2d.transform_kernel(w, segments))
        out, vjp = jax.vjp(fn_j, jnp.asarray(kernel))
        ct = np.random.default_rng(12).normal(size=out.shape).astype(np.float32)
        want = np.asarray(vjp(jnp.asarray(ct))[0])
        w = _oihw(kernel).requires_grad_()
        fn_t(w).backward(torch.from_numpy(np.ascontiguousarray(ct.transpose(3, 2, 0, 1))))
        np.testing.assert_allclose(_hwio(w.grad), want, rtol=1e-6, atol=1e-6)

    def test_segments_must_sum_to_cin(self):
        with pytest.raises(ValueError, match="do not sum"):
            s2d.transform_kernel(torch.zeros(2, 5, 3, 3), (2, 2))


class TestConvs:
    """float32 against JAX to 1e-5."""

    @pytest.mark.parametrize("k", [3, 1])
    def test_conv_s2d(self, k):
        x = _rand(5, 2, 6, 8, 4 * 3)
        kernel, bias = _rand(6, k, k, 3, 5), _rand(7, 5)
        want = jax_s2d.conv_s2d(jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias))
        got = s2d.conv_s2d(torch.from_numpy(x), _oihw(kernel), torch.from_numpy(bias))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    def test_conv_s2d_multi(self):
        xs = [_rand(8, 2, 6, 6, 4 * 4), _rand(9, 2, 6, 6, 4 * 2)]
        kernel, bias = _rand(10, 3, 3, 6, 3), _rand(11, 3)
        want = jax_s2d.conv_s2d_multi([jnp.asarray(x) for x in xs], jnp.asarray(kernel),
                                      jnp.asarray(bias), (4, 2))
        got = s2d.conv_s2d_multi([torch.from_numpy(x) for x in xs], _oihw(kernel),
                                 torch.from_numpy(bias), (4, 2))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        # The split conv equals one conv over the q-major concat with segments.
        cat = torch.cat([torch.from_numpy(x) for x in xs], dim=-1)
        joint = s2d.conv_s2d(cat, _oihw(kernel), torch.from_numpy(bias), (4, 2))
        np.testing.assert_allclose(got.numpy(), joint.numpy(), **TOL)

    def test_conv_s2d_to_dense_stride2(self):
        x = _rand(12, 2, 8, 6, 4 * 3)
        kernel, bias = _rand(13, 3, 3, 3, 4), _rand(14, 4)
        want = jax_s2d.conv_s2d_to_dense_stride2(jnp.asarray(x), jnp.asarray(kernel),
                                                 jnp.asarray(bias))
        got = s2d.conv_s2d_to_dense_stride2(torch.from_numpy(x), _oihw(kernel),
                                            torch.from_numpy(bias))
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    def test_instance_norm_s2d(self):
        x = _rand(15, 2, 6, 6, 4 * 5) * 2 + 0.5
        scale, bias = _rand(16, 5) * 0.5 + 1, _rand(17, 5)
        want = jax_s2d.instance_norm_s2d(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
        got = s2d.instance_norm_s2d(torch.from_numpy(x), torch.from_numpy(scale),
                                    torch.from_numpy(bias))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


class TestExactRewrite:
    """The s2d convs equal the port's dense convs on the full-resolution
    tensor (float32, to 1e-5: only the summation order differs)."""

    @pytest.mark.parametrize("k", [3, 1])
    def test_conv_s2d_equals_dense(self, k):
        x = torch.from_numpy(_rand(18, 2, 12, 10, 6))
        kernel, bias = torch.from_numpy(_rand(19, 4, 6, k, k)), torch.from_numpy(_rand(20, 4))
        dense = F.conv2d(x.permute(0, 3, 1, 2), kernel, bias, padding=k // 2).permute(0, 2, 3, 1)
        got = s2d.depth_to_space(s2d.conv_s2d(s2d.space_to_depth(x), kernel, bias))
        np.testing.assert_allclose(got.numpy(), dense.numpy(), **TOL)

    def test_stride2_equals_dense(self):
        x = torch.from_numpy(_rand(21, 2, 12, 16, 5))
        kernel, bias = torch.from_numpy(_rand(22, 3, 5, 3, 3)), torch.from_numpy(_rand(23, 3))
        dense = F.conv2d(x.permute(0, 3, 1, 2), kernel, bias, stride=2, padding=1)
        got = s2d.conv_s2d_to_dense_stride2(s2d.space_to_depth(x), kernel, bias)
        np.testing.assert_allclose(got.numpy(), dense.permute(0, 2, 3, 1).numpy(), **TOL)

    def test_instance_norm_s2d_equals_dense(self):
        from unet_implementations_tpu_torch.kernels.instance_norm import _torch_forward

        x = torch.from_numpy(_rand(24, 2, 8, 8, 3))
        scale, bias = torch.from_numpy(_rand(25, 3)), torch.from_numpy(_rand(26, 3))
        dense = _torch_forward(x, scale, bias, 1e-5, 1.0, 1)[0]  # slope 1: no activation
        got = s2d.depth_to_space(s2d.instance_norm_s2d(s2d.space_to_depth(x), scale, bias))
        np.testing.assert_allclose(got.numpy(), dense.numpy(), **TOL)
