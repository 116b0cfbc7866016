"""The port's CUDA kernels against their plain versions, on the card.

Every test is marked ``gpu`` and skips when no CUDA card is visible. The
file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q

Tolerances: K2 (upsample) is bitwise. K1 (InstanceNorm) sums in float32 in
another order than the plain version: float32 outputs agree to 1e-4, and
bfloat16 outputs within one bf16 ulp plus that 1e-4, since the float32
difference may tip the final rounding to the neighbouring bf16 value.
"""

import numpy as np
import pytest
import torch

from unet_implementations_tpu_torch.kernels import instance_norm as torch_in
from unet_implementations_tpu_torch.kernels.upsample import upsample2x_nhwc_fast
from unet_implementations_tpu_torch.models.unet import UNet
from unet_implementations_tpu_torch.ops.resize import upsample2x_nhwc
from unet_implementations_tpu_torch.recipes.common import predict_arrays

pytestmark = pytest.mark.gpu

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def bf16_ulps(a: np.ndarray, b: np.ndarray, atol: float) -> np.ndarray:
    """max(|a - b| - atol, 0) in units of the bf16 spacing at max(|a|, |b|)."""
    mag = np.maximum(np.abs(a), np.abs(b))
    exp = np.floor(np.log2(np.maximum(mag, np.float32(2.0 ** -126))))
    return np.maximum(np.abs(a - b) - atol, 0.0) / np.exp2(exp - 7)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape,group", [((2, 64, 64, 32), 1), ((2, 16, 16, 512), 1),
                                         ((2, 7, 9, 6), 1), ((2, 32, 32, 64), 4)])
def test_instance_norm(dtype, shape, group):
    _need_cuda()
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=shape) * 2 + 0.5).to("cuda", DTYPES[dtype])
    c = shape[-1] // group
    scale = torch.from_numpy(rng.normal(size=c) * 0.5 + 1.0).to("cuda", torch.float32)
    bias = torch.from_numpy(rng.normal(size=c) * 0.3).to("cuda", torch.float32)
    before = torch_in.fused_instance_norm.launches
    with torch.no_grad():
        got = torch_in.fused_instance_norm(x, scale, bias, 1e-5, 0.01, group)
        want = torch_in._torch_forward(x, scale, bias, 1e-5, 0.01, group)[0]
    assert torch_in.fused_instance_norm.launches == before + 1
    assert got.dtype == x.dtype and got.shape == x.shape
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        assert bf16_ulps(got, want, 1e-4).max() <= 1.0


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 16, 16, 512), (2, 64, 64, 64), (1, 5, 7, 6)])
def test_upsample_bitwise(dtype, shape):
    _need_cuda()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(shape))
    x = x.to("cuda", DTYPES[dtype])
    before = upsample2x_nhwc_fast.launches
    with torch.no_grad():
        assert torch.equal(upsample2x_nhwc_fast(x), upsample2x_nhwc(x))
    assert upsample2x_nhwc_fast.launches == before + 1


def test_refuses_grad():
    _need_cuda()
    x = torch.ones((1, 4, 4, 8), device="cuda", requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        upsample2x_nhwc_fast(x)
    with pytest.raises(RuntimeError, match="no backward"):
        torch_in.fused_instance_norm(x, torch.ones(8, device="cuda"),
                                     torch.zeros(8, device="cuda"))


def test_predict_arrays_runs_the_kernels():
    _need_cuda()
    model = UNet(features_per_stage=(8, 16, 16, 16, 16, 16), dtype=torch.bfloat16).cuda().eval()
    images = np.random.default_rng(2).integers(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    k1, k2 = torch_in.fused_instance_norm.launches, upsample2x_nhwc_fast.launches
    masks = predict_arrays(model, images, [(30, 40), (64, 64)])
    assert torch_in.fused_instance_norm.launches - k1 == 22
    assert upsample2x_nhwc_fast.launches - k2 == 5
    assert [m.shape for m in masks] == [(30, 40), (64, 64)]
    assert set(np.unique(np.concatenate([m.ravel() for m in masks]))) <= {0, 1, 2}
