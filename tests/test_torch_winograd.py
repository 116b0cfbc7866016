"""K4, the port's Winograd s2d conv (kernels/winograd.py), against JAX.

On the CPU ``winograd_conv_s2d`` runs its plain version ``_torch_winograd_s2d``
(the arithmetic of the JAX Pallas kernel in torch ops); it is held here to the
JAX op and to the Pallas kernel itself in interpret mode, in both U layouts,
forward and gradients, to 1e-4 of the output's largest magnitude (the
tolerance of ``tests/test_winograd.py``: Winograd reassociates the sums). The
CUDA kernel is held to this plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

The port takes kernels in PyTorch's (Cout, Cin, 3, 3) layout; the JAX
package in (3, 3, Cin, Cout).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_implementations_tpu.kernels import winograd as jax_wino
from unet_implementations_tpu_torch.kernels import winograd as wino
from unet_implementations_tpu_torch.ops.s2d import space_to_depth


def _case(seed, n, s, cin, cout):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, s, s, cin)).astype(np.float32)
    w = (rng.normal(size=(3, 3, cin, cout)) * 0.05).astype(np.float32)  # HWIO
    b = rng.normal(size=(cout,)).astype(np.float32)
    return x, w, b


def _oihw(w_hwio: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))


def _assert_close_of_max(got, want, tol=1e-4):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = float(np.max(np.abs(want))) + 1e-8
    np.testing.assert_allclose(got / scale, want / scale, atol=tol)


class TestWeightTransforms:
    def test_unfolded_matches_jax(self):
        _, w, _ = _case(0, 1, 8, 128, 256)
        got = wino.transform_weights(_oihw(w))
        assert got.shape == (16, 128, 256) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(jax_wino.transform_weights(w)),
                                   rtol=1e-6, atol=1e-6)

    def test_folded_matches_jax(self):
        _, w, _ = _case(1, 1, 8, 128, 128)
        got = wino.transform_weights_folded(_oihw(w))
        assert got.shape == (8, 3 * 128, 128)
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(jax_wino.transform_weights_folded(w)),
                                   rtol=1e-6, atol=1e-6)


class TestPacking:
    """``pack_weights``: the U the bf16 kernel copies, one contiguous run per
    (column block of N = 128 output channels, 64 folded; chunk of 16 input
    channels), each in wgmma's no-swizzle core-matrix order."""

    @staticmethod
    def _u(folded, cin, cout):
        w = _oihw(_case(8, 1, 8, cin, cout)[1])
        return (wino.transform_weights_folded if folded else wino.transform_weights)(w)

    @pytest.mark.parametrize("cout", [128, 1024])
    @pytest.mark.parametrize("cin", [128, 1024])
    @pytest.mark.parametrize("folded", [False, True], ids=["unfolded", "folded"])
    def test_unpacks_to_the_transform(self, folded, cin, cout):
        u = self._u(folded, cin, cout)
        packed = wino.pack_weights(u)
        mats, n = (24, 64) if folded else (16, 128)
        assert packed.shape == (cout // n, cin // 16, mats, 2, n // 8, 8, 8)
        assert packed.is_contiguous() and packed.dtype == u.dtype
        # The inverse of the packing's permutation restores U exactly.
        unpacked = packed.permute(2, 1, 3, 6, 0, 4, 5).reshape(u.shape)
        assert torch.equal(unpacked, u)

        # Run (cb, ch) sits where the kernel reads it: at (cb·Cin/16 + ch) ·
        # mats·16·N elements; inside it, matrix m at m·16·N, then the core
        # matrices of 8 input by 8 output channels, 8·N elements apart in K
        # and 64 apart in N, each row of 8 input channels contiguous.
        flat = packed.reshape(-1)
        mat = u.reshape(mats, cin, cout)  # matrix m = 3·(2b+r) + idx folded
        nchunks, run = cin // 16, mats * 16 * n
        m, k, c = torch.meshgrid(torch.arange(mats), torch.arange(16), torch.arange(n),
                                 indexing="ij")
        within = m * 16 * n + (k // 8) * 8 * n + (c // 8) * 64 + (c % 8) * 8 + k % 8
        for cb, ch in {(0, 0), (0, nchunks - 1), (cout // n - 1, 1),
                       (cout // n - 1, nchunks - 1)}:
            got = flat[(cb * nchunks + ch) * run + within]
            assert torch.equal(got, mat[m, 16 * ch + k, n * cb + c])

    def test_refuses_shapes_the_kernel_does_not_take(self):
        with pytest.raises(ValueError, match="multiple"):
            wino.pack_weights(torch.zeros(16, 128, 96))


class TestPlainVersion:
    """``_torch_winograd_s2d`` at the dense (1, 16, 16, 128) case of
    ``tests/test_winograd.py``, against ``winograd_conv_s2d(interpret=True)``
    (which runs the unfolded Pallas kernel) and ``_wino_s2d_pallas`` with the
    same U, in interpret mode."""

    @pytest.mark.parametrize("folded", [False, True], ids=["unfolded", "folded"])
    def test_matches_pallas_kernel(self, folded):
        x, w, b = _case(2, 1, 16, 128, 128)
        x_s2d = np.array(jax_wino._space_to_depth(jnp.asarray(x)))
        tw = jax_wino.transform_weights_folded if folded else jax_wino.transform_weights
        u = np.array(tw(jnp.asarray(w)))
        want = jax_wino._wino_s2d_pallas(jnp.asarray(x_s2d), jnp.asarray(u),
                                         jnp.asarray(b).reshape(1, -1), out_dtype=jnp.float32,
                                         interpret=True)
        got = wino._torch_winograd_s2d(torch.from_numpy(x_s2d), torch.from_numpy(u),
                                       torch.from_numpy(b))
        _assert_close_of_max(got.numpy(), want)

    @pytest.mark.parametrize("folded", [False, True], ids=["unfolded", "folded"])
    def test_op_matches_jax_op(self, folded, monkeypatch):
        monkeypatch.setattr(wino, "_FOLDED", folded)
        x, w, b = _case(3, 1, 16, 128, 128)
        x_s2d = np.array(jax_wino._space_to_depth(jnp.asarray(x)))
        want = jax_wino.winograd_conv_s2d(jnp.asarray(x_s2d), jnp.asarray(w), jnp.asarray(b),
                                          True)
        got = wino.winograd_conv_s2d(torch.from_numpy(x_s2d), _oihw(w), torch.from_numpy(b))
        _assert_close_of_max(got.numpy(), want)
        # And the dense convenience wrapper against the direct conv.
        ref = jax_wino._direct_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
        dense = wino.winograd_conv(torch.from_numpy(x), _oihw(w), torch.from_numpy(b))
        _assert_close_of_max(dense.numpy(), ref)

    def test_layout_is_the_ports_space_to_depth(self):
        x, _, _ = _case(4, 2, 8, 4, 4)
        np.testing.assert_array_equal(space_to_depth(torch.from_numpy(x)).numpy(),
                                      np.asarray(jax_wino._space_to_depth(jnp.asarray(x))))

    def test_bf16_transforms_round_in_the_dtype(self):
        """In bf16 the plain version rounds each transform add to bf16, as the
        JAX kernel does, and stays a bf16-accurate conv."""
        x, w, b = _case(5, 1, 16, 128, 128)
        x_s2d = space_to_depth(torch.from_numpy(x)).to(torch.bfloat16)
        u = wino.transform_weights(_oihw(w)).to(torch.bfloat16)
        got = wino._torch_winograd_s2d(x_s2d, u, torch.from_numpy(b))
        assert got.dtype == torch.bfloat16
        ref = jax_wino._space_to_depth(jax_wino._direct_conv(
            jnp.asarray(x_s2d.float().numpy().reshape(1, 8, 8, 2, 2, 128).transpose(
                0, 1, 3, 2, 4, 5).reshape(1, 16, 16, 128)), jnp.asarray(w), jnp.asarray(b)))
        _assert_close_of_max(got.float().numpy(), ref, tol=2e-2)


class TestGradients:
    """The autograd of ``winograd_conv`` against ``jax.grad`` of the JAX op
    (custom_vjp, Pallas in interpret mode) at the (1, 8, 8, 128) case of
    ``tests/test_winograd.py``, in both U layouts."""

    @pytest.mark.parametrize("folded", [False, True], ids=["unfolded", "folded"])
    def test_matches_jax_grad(self, folded, monkeypatch):
        monkeypatch.setattr(wino, "_FOLDED", folded)
        x, w, b = _case(6, 1, 8, 128, 128)

        def f_jax(x, w, b):
            return jnp.sum(jax_wino.winograd_conv(x, w, b, interpret=True) ** 2)

        want = jax.grad(f_jax, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
        xt = torch.from_numpy(x).requires_grad_()
        wt = _oihw(w).requires_grad_()
        bt = torch.from_numpy(b).requires_grad_()
        (wino.winograd_conv(xt, wt, bt) ** 2).sum().backward()
        _assert_close_of_max(xt.grad.numpy(), want[0])
        _assert_close_of_max(wt.grad.numpy().transpose(2, 3, 1, 0), want[1])
        _assert_close_of_max(bt.grad.numpy(), want[2])

    def test_cpu_calls_count_no_launches(self):
        x, w, b = _case(7, 1, 8, 128, 128)
        before = (wino.winograd_conv_s2d.launches, wino.winograd_conv_s2d.launches_folded)
        xt = space_to_depth(torch.from_numpy(x)).requires_grad_()
        wino.winograd_conv_s2d(xt, _oihw(w), torch.from_numpy(b)).sum().backward()
        assert (wino.winograd_conv_s2d.launches,
                wino.winograd_conv_s2d.launches_folded) == before


class TestEligibility:
    @pytest.mark.parametrize("dense,kernel,stride", [
        ((1, 64, 64, 256), (3, 3, 256, 256), 1),
        ((1, 64, 64, 256), (3, 3, 256, 256), 2),
        ((1, 64, 64, 64), (3, 3, 64, 128), 1),
        ((1, 63, 64, 256), (3, 3, 256, 256), 1),
        ((1, 4, 4, 256), (3, 3, 256, 256), 1),
        ((1, 64, 64, 256), (1, 1, 256, 256), 1),
        ((32, 32, 32, 1024), (3, 3, 1024, 512), 1),
    ])
    def test_matches_jax(self, dense, kernel, stride):
        kh, kw, cin, cout = kernel
        assert wino.eligible(dense, (cout, cin, kh, kw), stride) == \
            jax_wino.eligible(dense, kernel, stride)

    def test_shape_mismatch_raises(self):
        with pytest.raises(ValueError, match="s2d channels"):
            wino.winograd_conv_s2d(torch.zeros(1, 4, 4, 4 * 128), torch.zeros(128, 64, 3, 3),
                                   torch.zeros(128))


def test_profiling_kind():
    from unet_implementations_tpu_torch.utils.profiling import kind_of

    for name in ("void unet::(anonymous namespace)::wg::winograd_s2d_wgmma_kernel<false>(x)",
                 "void unet::(anonymous namespace)::wg::winograd_s2d_wgmma_kernel<true>(x)",
                 "void unet::(anonymous namespace)::f32::winograd_s2d_f32_kernel<false>(x)"):
        assert kind_of(name) == "K4 winograd s2d conv"
