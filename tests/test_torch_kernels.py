"""The port's kernels (unet_implementations_tpu_torch/kernels) against JAX.

On the CPU each wrapper runs its plain PyTorch version; those are held here
to the JAX functions the CUDA kernels replace: the jnp reference and the
Pallas kernel body in interpret mode. The CUDA kernels themselves are held
to these plain versions on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from unet_implementations_tpu.kernels import instance_norm as jax_in
from unet_implementations_tpu.kernels import s2d_region as jax_region
from unet_implementations_tpu.kernels.upsample import (
    _upsample2x_dense_pallas,
    _upsample2x_s2d_pallas,
)
from unet_implementations_tpu.models.s2d import upsample2x_into_s2d as jax_upsample_s2d
from unet_implementations_tpu.ops.resize import upsample2x_nhwc as jax_upsample2x
from unet_implementations_tpu_torch.kernels import _build
from unet_implementations_tpu_torch.kernels import instance_norm as torch_in
from unet_implementations_tpu_torch.kernels import s2d_region as torch_region
from unet_implementations_tpu_torch.kernels.upsample import (
    upsample2x_into_s2d_fast,
    upsample2x_nhwc_fast,
)
from unet_implementations_tpu_torch.ops.s2d import upsample2x_into_s2d
from unet_implementations_tpu_torch.ops.resize import upsample2x_nhwc

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _bf16_ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|a - b| in units of the bf16 spacing at max(|a|, |b|) (float32 inputs
    holding bf16 values)."""
    mag = np.maximum(np.abs(a), np.abs(b))
    exp = np.floor(np.log2(np.maximum(mag, np.float32(2.0 ** -126))))
    return np.abs(a - b) / np.exp2(exp - 7)


def _in_case(seed, shape, group):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
    c = shape[-1] // group
    scale = (rng.normal(size=(c,)) * 0.5 + 1.0).astype(np.float32)
    bias = (rng.normal(size=(c,)) * 0.3).astype(np.float32)
    return x, scale, bias


def _jax_in(x, scale, bias, group, jdtype, impl):
    args = (jnp.asarray(x, jdtype), jnp.asarray(scale), jnp.asarray(bias), 1e-5, 0.01, group)
    if impl == "pallas":
        with pltpu.force_tpu_interpret_mode():
            return jax_in._pallas_forward(*args)
    return jax_in._jnp_forward(*args)


class TestInstanceNormPlain:
    """K1's plain version: f32 to rtol 1e-5; bf16 within 1 ulp, because
    float32 sums taken in another order may round the final value to the
    neighbouring bf16."""

    @pytest.mark.parametrize("impl", ["jnp", "pallas"])
    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    @pytest.mark.parametrize("group", [1, 4])
    def test_matches_jax(self, impl, dtype, group):
        jdtype, tdtype = DTYPES[dtype]
        x, scale, bias = _in_case(group, (2, 16, 16, 8), group)
        y_j, mean_j, rstd_j = _jax_in(x, scale, bias, group, jdtype, impl)
        x_t = torch.from_numpy(np.array(jnp.asarray(x, jdtype).astype(jnp.float32)))
        y_t, mean_t, rstd_t = torch_in._torch_forward(
            x_t.to(tdtype), torch.from_numpy(scale), torch.from_numpy(bias), 1e-5, 0.01, group)
        assert y_t.dtype == tdtype and y_t.shape == x.shape
        np.testing.assert_allclose(mean_t.numpy(), np.asarray(mean_j), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(rstd_t.numpy(), np.asarray(rstd_j), rtol=1e-5)
        got = y_t.to(torch.float32).numpy()
        want = np.asarray(y_j.astype(jnp.float32))
        if dtype == "f32":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        else:
            assert _bf16_ulps(got, want).max() <= 1.0

    def test_wrapper_runs_plain_on_cpu_without_counting(self):
        x, scale, bias = _in_case(7, (1, 8, 8, 12), 4)
        args = (torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias))
        before = torch_in.fused_instance_norm.launches
        y = torch_in.fused_instance_norm(*args, 1e-5, 0.01, 4)
        assert torch_in.fused_instance_norm.launches == before
        assert torch.equal(y, torch_in._torch_forward(*args, 1e-5, 0.01, 4)[0])

    def test_wrapper_refuses_other_devices(self):
        x = torch.empty((1, 4, 4, 8), device="meta")
        scale = torch.ones(8, device="meta")
        with pytest.raises(ValueError, match="CPU or all on CUDA"):
            torch_in.fused_instance_norm(x, scale, scale)


class TestUpsamplePlain:
    """K2's plain version: bitwise in bf16, <= 1e-6 in f32."""

    SHAPES = [(2, 16, 16, 8), (1, 8, 12, 16), (3, 5, 7, 4)]

    @pytest.mark.parametrize("impl", ["jnp", "pallas"])
    @pytest.mark.parametrize("shape", SHAPES)
    def test_bf16_bitwise(self, impl, shape):
        x = jnp.asarray(np.random.default_rng(shape[1]).standard_normal(shape), jnp.bfloat16)
        want = _upsample2x_dense_pallas(x, interpret=True) if impl == "pallas" \
            else jax_upsample2x(x)
        got = upsample2x_nhwc(
            torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16))
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                      np.asarray(want.astype(jnp.float32)))

    @pytest.mark.parametrize("impl", ["jnp", "pallas"])
    def test_f32(self, impl):
        x = np.random.default_rng(0).standard_normal((1, 16, 16, 8)).astype(np.float32)
        want = _upsample2x_dense_pallas(jnp.asarray(x), interpret=True) if impl == "pallas" \
            else jax_upsample2x(jnp.asarray(x))
        got = upsample2x_nhwc(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)

    def test_wrapper_runs_plain_on_cpu_without_counting(self):
        x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 4, 6, 8)))
        before = upsample2x_nhwc_fast.launches
        assert torch.equal(upsample2x_nhwc_fast(x), upsample2x_nhwc(x))
        assert upsample2x_nhwc_fast.launches == before

    def test_wrapper_refuses_bad_rank(self):
        with pytest.raises(ValueError, match="B, H, W, C"):
            upsample2x_nhwc_fast(torch.zeros(4, 4, 8))


class TestUpsampleS2dPlain:
    """K2b's CPU wrapper (its plain version) against the JAX jnp reference
    and the Pallas kernel in interpret mode: bitwise, except float32 against
    the interpreted Pallas kernel, which XLA compiles with fused multiply-adds
    (it differs from JAX's own jnp reference there): <= 1e-6."""

    SHAPES = [(2, 8, 8, 8), (1, 6, 10, 16), (2, 5, 7, 4)]

    @pytest.mark.parametrize("impl", ["jnp", "pallas"])
    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    @pytest.mark.parametrize("shape", SHAPES)
    def test_bitwise(self, impl, dtype, shape):
        jdtype, tdtype = DTYPES[dtype]
        x = jnp.asarray(np.random.default_rng(shape[2]).standard_normal(shape), jdtype)
        want = _upsample2x_s2d_pallas(x, interpret=True) if impl == "pallas" \
            else jax_upsample_s2d(x)
        before = upsample2x_into_s2d_fast.launches
        got = upsample2x_into_s2d_fast(
            torch.from_numpy(np.array(x.astype(jnp.float32))).to(tdtype))
        assert upsample2x_into_s2d_fast.launches == before
        assert got.dtype == tdtype and tuple(got.shape) == want.shape
        got, want = got.to(torch.float32).numpy(), np.asarray(want.astype(jnp.float32))
        if impl == "pallas" and dtype == "f32":
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
        else:
            np.testing.assert_array_equal(got, want)

    def test_wrapper_refuses_bad_rank(self):
        with pytest.raises(ValueError, match="B, H, W, C"):
            upsample2x_into_s2d_fast(torch.zeros(4, 4, 8))


def _tail_case(seed, b=2, h=16, w=128, c=8):
    """The shapes of ``tests/test_s2d_region.py::_mk``, from numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, w, 4 * c)).astype(np.float32)
    scale1 = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias1 = (rng.normal(size=c) * 0.1).astype(np.float32)
    k2 = (rng.normal(size=(3, 3, c, c)) * 0.2).astype(np.float32)
    scale2 = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias2 = (rng.normal(size=c) * 0.1).astype(np.float32)
    return x, scale1, bias1, k2, scale2, bias2


class TestS2dTailPlain:
    """K3's CPU wrapper (its plain version) against the JAX ``jnp_tail`` and
    ``_pallas_tail`` in interpret mode, with JAX's own tolerances: f32 2e-5,
    bf16 4e-2."""

    TOL = {"f32": 2e-5, "bf16": 4e-2}

    @pytest.mark.parametrize("impl", ["jnp", "pallas"])
    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    def test_matches_jax(self, impl, dtype):
        jdtype, tdtype = DTYPES[dtype]
        x, scale1, bias1, k2, scale2, bias2 = _tail_case(0)
        xj = jnp.asarray(x, jdtype)
        args = (xj, jnp.asarray(scale1), jnp.asarray(bias1), jnp.asarray(k2),
                jnp.asarray(scale2), jnp.asarray(bias2))
        if impl == "pallas":
            want = jax_region._pallas_tail(*args, eps=1e-5, neg=0.01, interpret=True)
        else:
            want = jax_region.jnp_tail(*args)
        before = torch_region.fused_s2d_tail.launches
        got = torch_region.fused_s2d_tail(
            torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdtype),
            torch.from_numpy(scale1), torch.from_numpy(bias1),
            torch.from_numpy(np.ascontiguousarray(k2.transpose(3, 2, 0, 1))),
            torch.from_numpy(scale2), torch.from_numpy(bias2))
        assert torch_region.fused_s2d_tail.launches == before
        assert got.dtype == tdtype and tuple(got.shape) == x.shape
        tol = self.TOL[dtype]
        np.testing.assert_allclose(got.to(torch.float32).numpy(),
                                   np.asarray(want.astype(jnp.float32)), atol=tol, rtol=tol)

    def test_conv_bias_cancels(self):
        """The module composition WITH conv_1's bias equals the tail without
        it (f32, 1e-5): IN2 subtracts the bias with the mean."""
        from unet_implementations_tpu_torch.ops import s2d

        x, scale1, bias1, k2, scale2, bias2 = (torch.from_numpy(a) for a in _tail_case(1, c=8))
        weight = k2.permute(3, 2, 0, 1).contiguous()
        bias_c = torch.from_numpy(np.random.default_rng(9).normal(size=8).astype(np.float32))
        y = s2d.instance_norm_s2d(x, scale1, bias1)
        y = torch.where(y >= 0, y, y * 0.01)
        y = s2d.conv_s2d(y, weight, bias_c)
        y = s2d.instance_norm_s2d(y, scale2, bias2)
        want = torch.where(y >= 0, y, y * 0.01)
        got = torch_region.fused_s2d_tail(x, scale1, bias1, weight, scale2, bias2)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)

    def test_wrapper_refuses_other_devices(self):
        x = torch.empty((1, 4, 4, 32), device="meta")
        v = torch.ones(8)
        with pytest.raises(ValueError, match="CPU or all on CUDA"):
            torch_region.fused_s2d_tail(x, v, v, torch.zeros(8, 8, 3, 3), v, v)


def test_profiling_kinds():
    """utils/profiling.py files each of the port's kernels under its own kind
    (K2's template flag tells K2b from K2a)."""
    from unet_implementations_tpu_torch.utils.profiling import kind_of

    ns = "void unet::(anonymous namespace)::"
    assert kind_of(ns + "upsample2x_kernel<__nv_bfloat16, 8, true>(x)") == "K2b upsample into s2d"
    assert kind_of(ns + "upsample2x_kernel<__nv_bfloat16, 8, false>(x)") == "K2a upsample"
    assert kind_of(ns + "s2d_conv_kernel<32>(x)") == "K3 s2d tail conv"
    assert kind_of(ns + "wg::s2d_conv_wgmma_kernel<64>(x)") == "K3 s2d tail conv"
    assert kind_of(ns + "in_finalize_kernel(x)") == "K1a instance norm statistics"
    assert kind_of("sm90_xmma_fprop_implicit_gemm_bf16") == "convolution"
    assert kind_of("elementwise_kernel<CUDAFunctor_add>") == "other"


class TestBuild:
    def test_missing_nvcc_raises(self, monkeypatch, tmp_path):
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
        monkeypatch.setattr(_build.shutil, "which", lambda name: None)
        monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
        monkeypatch.delenv("CUDA_PATH", raising=False)
        with pytest.raises(RuntimeError, match="nvcc was not found"):
            _build.build()

    def test_sources_and_flags(self):
        names = sorted(p.name for p in _build.CSRC_DIR.glob("*.cu"))
        assert names == ["fp8_conv.cu", "instance_norm.cu", "runtime.cu", "s2d_region.cu",
                         "upsample.cu", "winograd.cu"]
        assert "-gencode=arch=compute_90a,code=sm_90a" in _build.COMPILE_FLAGS

