"""The port's CUDA kernels against their plain versions, on the card.

Every test is marked ``gpu`` and skips when no CUDA card is visible. The
file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q

Tolerances: K2 (upsample, K2a and K2b) is bitwise. K1 (InstanceNorm) sums
in float32 in another order than the plain version: float32 outputs agree to
1e-4, and bfloat16 outputs within one bf16 ulp plus that 1e-4, since the
float32 difference may tip the final rounding to the neighbouring bf16 value.
K3 (the s2d block tail): float32 to 1e-4 (sum orders). bfloat16: the conv
sums in another order than cuDNN, so a conv output may round one bf16 ulp
the other way, and IN2 carries that ulp into the result scaled by
|scale2 · rstd2| (``_torch_tail(carried_ulp=True)``); the result may also
round once more the other way, and K1's apply pass activates before it
rounds (one more ulp): two bf16 ulps of the result plus the carried conv ulp
plus 1e-4, for all but 1e-4 of the elements (IN1's statistics, summed in
another order, round a few conv inputs the other way too); and the kernel is
as close to the float32 computation as the plain version (max and mean
|error| within 25%). K4 (the Winograd s2d conv): float32 (TF32 off) to 1e-4
of the largest magnitude, forward and gradients, against the plain version
and the direct conv; bfloat16 no further from the float32 direct conv than
the plain version, +25% on relative L2. The reasons are set out in
``chip_smoke.py``. K1's backward kernel against ``_torch_backward`` on the
same inputs and statistics: float32 dx, dscale and dbias to 1e-4 of their
largest magnitude (sum orders, and its factored sums: Σdpre times scale where
the plain version sums dpre·scale); bfloat16 dx within one bf16 ulp plus
1e-4, dscale and dbias (float32) to 1e-4 of their largest magnitude. Under
a space group of one rank, K1's split forward and backward against the
one-launch forward (statistics to 1e-6) and the two-pass backward (bit for
bit). K2's
backward is plain torch on both devices: its gradients are held to the CPU's.
SSIM's blur is elementwise float32, so with TF32 allowed in cuDNN it still
equals a float64 computation on the CPU to 1e-5. The CLIP tower launches no
kernel of the port; in float32 (TF32 off) it equals the CPU's to 1e-5
relative L2. The fp8 conv (``kernels/fp8_conv.py``): its casts bit for bit
the plain version's on every bf16 and fp16 value; the conv alone (no bias) within
one bf16 ulp of the exact sum (float64 of the same fp8 values, on the CPU)
plus float32's summation bound, K·2^-24·Σ|products| (the plain version sums
the same exact products in float32 in another order), at the general
kernel's shapes and at the wgmma kernel's edges (its launch count, a repeat
bit for bit, its epilogue and packed weights bit for bit); the mode raises
under autograd. The upsample folds (``ops/s2d.py``) against the plain
upsample and the unfolded convs at ``tests/test_up_fold.py``'s tolerances
(2e-5 + 1e-4·|x|, float32, TF32 off); K2b on halo'd row shards bit for bit
the unsharded K2b; a folded s2d forward launches no K2a or K2b.
"""

import numpy as np
import pytest
import torch

from unet_implementations_tpu_torch.data.synthetic import as_uint8, synthetic_batch
from unet_implementations_tpu_torch.kernels import fp8_conv as k8
from unet_implementations_tpu_torch.kernels import instance_norm as torch_in
from unet_implementations_tpu_torch.kernels import s2d_region as torch_region
from unet_implementations_tpu_torch.kernels import winograd
from unet_implementations_tpu_torch.kernels.upsample import (
    upsample2x_into_s2d_fast,
    upsample2x_nhwc_fast,
)
from unet_implementations_tpu_torch.models import clip
from unet_implementations_tpu_torch.ops.s2d import (
    depth_to_space,
    space_to_depth,
    upsample2x_into_s2d,
)
from unet_implementations_tpu_torch.models.unet import S2D_LAYOUT, UNet, unet_6stage
from unet_implementations_tpu_torch.ops.losses import ssim
from unet_implementations_tpu_torch.ops.resize import upsample2x_nhwc
from unet_implementations_tpu_torch.recipes.common import predict_arrays
from unet_implementations_tpu_torch.training import steps, train_state

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


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_upsample_s2d_halo_bitwise(dtype):
    """K2b on two row shards, each with its neighbour's edge row (its own at
    the image's edge), gives the unsharded K2b's rows bit for bit."""
    from unet_implementations_tpu_torch.kernels.upsample import upsample2x_into_s2d_halo

    _need_cuda()
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 16, 12, 64)))
    x = x.to("cuda", DTYPES[dtype])
    before = upsample2x_into_s2d_fast.launches
    with torch.no_grad():
        top = upsample2x_into_s2d_halo(x[:, :8], x[:, :1], x[:, 8:9])
        bottom = upsample2x_into_s2d_halo(x[:, 8:], x[:, 7:8], x[:, -1:])
        assert torch.equal(torch.cat([top, bottom], dim=1), upsample2x_into_s2d_fast(x))
    assert upsample2x_into_s2d_fast.launches == before + 3


def test_up_folds_against_the_composite(monkeypatch):
    """The folds on the card (float32, TF32 off) against the plain upsample
    and the unfolded convs, at tests/test_up_fold.py's tolerances."""
    from unet_implementations_tpu_torch.ops import s2d

    _need_cuda()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((2, 16, 16, 64), generator=g, device="cuda")
    skip_s2d = torch.randn((2, 16, 16, 128), generator=g, device="cuda")
    skip = torch.randn((2, 32, 32, 32), generator=g, device="cuda")
    w = torch.randn((32, 96, 3, 3), generator=g, device="cuda") * 0.05
    b = torch.randn((32,), generator=g, device="cuda") * 0.1
    with torch.no_grad():
        got = s2d.conv_s2d_multi_up_fold(x, [skip_s2d], w, b, (64, 32))
        want = s2d.conv_s2d_multi([s2d.upsample2x_into_s2d(x), skip_s2d], w, b, (64, 32))
        torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)
        got = s2d.conv_dense_up_fold(x, [skip], w, b)
        both = torch.cat([upsample2x_nhwc(x), skip], dim=-1).permute(0, 3, 1, 2)
        want = torch.nn.functional.conv2d(both, w, b, padding=1).permute(0, 2, 3, 1)
        torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)


def test_folded_s2d_forward_launches_no_upsample(monkeypatch):
    """With ``UNET_TPU_S2D_UP_FOLD=1`` an s2d model's eval forward runs no K2a
    or K2b (its dense decoder folds too in eval) and still its K3, within
    1e-4 relative L2 of the unfolded forward (float32, TF32 off)."""
    _need_cuda()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    model = UNet(features_per_stage=(8, 32, 32), strides=(1, 2, 2), **S2D_LAYOUT,
                 encoder_dropout_rates=(0.0,) * 3, decoder_dropout_rates=(0.0,) * 2).cuda().eval()
    x = torch.randn((2, 32, 32, 3), generator=torch.Generator(device="cuda").manual_seed(4),
                    device="cuda")
    counts = (upsample2x_nhwc_fast, upsample2x_into_s2d_fast, torch_region.fused_s2d_tail)
    with torch.no_grad():
        want = model(x)
        monkeypatch.setenv("UNET_TPU_S2D_UP_FOLD", "1")
        before = [fn.launches for fn in counts]
        got = model(x)
    assert [fn.launches - n for fn, n in zip(counts, before)] == [0, 0, 3]
    assert float((got - want).norm() / want.norm()) <= 1e-4


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 16, 16, 128), (2, 32, 32, 64), (1, 5, 7, 6)])
def test_upsample_s2d_bitwise(dtype, shape):
    _need_cuda()
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(shape))
    x = x.to("cuda", DTYPES[dtype])
    before = upsample2x_into_s2d_fast.launches
    with torch.no_grad():
        assert torch.equal(upsample2x_into_s2d_fast(x), upsample2x_into_s2d(x))
    assert upsample2x_into_s2d_fast.launches == before + 1


def _tail_args(shape, dtype, seed=3, tap=None):
    """x and the tail's parameters; with ``tap``, conv_1's kernel is zero but
    at that tap (ky * 3 + kx)."""
    rng = np.random.default_rng(seed)
    c = shape[-1] // 4

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to("cuda", dt)

    w = rng.normal(size=(c, c, 3, 3)) * np.sqrt(2 / (9 * c))
    if tap is not None:
        w *= (np.arange(9) == tap).reshape(3, 3)
    return (t(rng.normal(size=shape), DTYPES[dtype]), t(rng.uniform(0.5, 1.5, c)),
            t(rng.normal(size=c) * 0.1), t(w), t(rng.uniform(0.5, 1.5, c)),
            t(rng.normal(size=c) * 0.1))


def _check_tail(args, slope=0.01):
    """One launch of K3 against its plain version (tolerances: module doc)."""
    x = args[0]
    before = torch_region.fused_s2d_tail.launches
    with torch.no_grad():
        got = torch_region.fused_s2d_tail(*args, 1e-5, slope)
        want, carried = torch_region._torch_tail(*args, 1e-5, slope, carried_ulp=True)
        ref = torch_region._torch_tail(x.float(), *args[1:], 1e-5, slope)
    assert torch_region.fused_s2d_tail.launches == before + 1
    assert got.dtype == x.dtype and got.shape == x.shape
    got, want, carried, ref = (v.float().cpu().numpy() for v in (got, want, carried, ref))
    if x.dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        assert (bf16_ulps(got, want, 1e-4 + carried) > 2.0).mean() <= 1e-4
        e_k, e_p = np.abs(got - ref), np.abs(want - ref)
        assert e_k.max() <= 1.25 * e_p.max() and e_k.mean() <= 1.25 * e_p.mean()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 16, 128, 32), (2, 32, 32, 128), (2, 16, 16, 256),
                                   (1, 9, 13, 64)])
def test_s2d_tail(dtype, shape, monkeypatch):
    _need_cuda()
    # The plain version's conv is cuDNN's: float32 without TF32, as the kernel.
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    _check_tail(_tail_args(shape, dtype))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 16, 16, 32), (16, 64, 64, 128), (32, 32, 32, 256)])
def test_s2d_tail_c8_and_several_items_per_block(dtype, shape, monkeypatch):
    """C = 8 (padded to 16 in bf16); and batches whose bands outnumber the
    persistent blocks (512 bands at C = 32 and 64), so each block walks
    several items and the ring wraps many times."""
    _need_cuda()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    _check_tail(_tail_args(shape, dtype, seed=4))


@pytest.mark.parametrize("shape", [(2, 16, 64, 128), (2, 16, 16, 256)])
def test_s2d_tail_slope_above_one(shape, monkeypatch):
    """The bf16 conv takes LeakyReLU as max(t, t * slope) only for 0 <= slope
    <= 1; a slope of 1.5 takes its sign-bit select."""
    _need_cuda()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    _check_tail(_tail_args(shape, "bf16", seed=7), slope=1.5)


@pytest.mark.parametrize("tap", range(9))
def test_s2d_tail_one_tap(tap):
    """conv_1's kernel at one tap only: the bf16 conv's A operand for that
    tap is the stage at a shifted start address, and a wrong shift, stride or
    leading byte offset of the descriptor moves every output."""
    _need_cuda()
    _check_tail(_tail_args((2, 16, 48, 128), "bf16", seed=5, tap=tap))


@pytest.mark.parametrize("shape", [(2, 16, 128, 32), (4, 32, 32, 256), (1, 9, 13, 64)])
def test_s2d_tail_bf16_repeats_bitwise(shape):
    """No atomics: two bf16 calls on the same input are bit for bit equal."""
    _need_cuda()
    args = _tail_args(shape, "bf16", seed=6)
    with torch.no_grad():
        a = torch_region.fused_s2d_tail(*args)
        b = torch_region.fused_s2d_tail(*args)
    assert torch.equal(a, b)


def test_s2d_tail_refuses_unsupported_channels():
    _need_cuda()
    x = torch.zeros((1, 8, 8, 4 * 24), device="cuda")
    v = torch.ones(24, device="cuda")
    with torch.no_grad(), pytest.raises(ValueError, match="C in"):
        torch_region.fused_s2d_tail(x, v, v, torch.zeros((24, 24, 3, 3), device="cuda"), v, v)


def test_refuses_grad():
    """K3 is inference-only (as in JAX); K1 and K2 take gradients."""
    _need_cuda()
    x = torch.ones((1, 4, 4, 4 * 8), device="cuda", requires_grad=True)
    v = torch.ones(8, device="cuda")
    with pytest.raises(RuntimeError, match="no backward"):
        torch_region.fused_s2d_tail(x, v, v, torch.zeros((8, 8, 3, 3), device="cuda"), v, v)
    for fn in (upsample2x_nhwc_fast, upsample2x_into_s2d_fast):
        fn(x).sum().backward()
    torch_in.fused_instance_norm(x, torch.ones(32, device="cuda"),
                                 torch.zeros(32, device="cuda")).sum().backward()


@pytest.mark.parametrize("group", [1, 4])
def test_instance_norm_grad(group):
    _need_cuda()
    rng = np.random.default_rng(group)
    x = torch.from_numpy(rng.normal(size=(2, 16, 16, 32)) * 2 + 0.5).float()
    c = 32 // group
    scale = torch.from_numpy(rng.normal(size=c) * 0.5 + 1.0).float()
    bias = torch.from_numpy(rng.normal(size=c) * 0.3).float()
    dy = torch.from_numpy(rng.normal(size=x.shape)).float()
    grads = []
    for device in ("cpu", "cuda"):
        args = [t.to(device).detach().requires_grad_() for t in (x, scale, bias)]
        before = torch_in.fused_instance_norm.launches
        before_bwd = torch_in.fused_instance_norm.backward_launches
        torch_in.fused_instance_norm(*args, 1e-5, 0.01, group).backward(dy.to(device))
        assert torch_in.fused_instance_norm.launches - before == (device == "cuda")
        assert torch_in.fused_instance_norm.backward_launches - before_bwd == (device == "cuda")
        grads.append([a.grad.cpu() for a in args])
    for got, want in zip(grads[1], grads[0]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def _k1_backward_case(shape, group, dtype, seed=5):
    """x, scale, bias, the kernel forward's mean and rstd, and dy."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=shape) * 2 + 0.5).to("cuda", dtype)
    c = shape[-1] // group
    scale = torch.from_numpy(rng.normal(size=c) * 0.5 + 1.0).to("cuda", torch.float32)
    bias = torch.from_numpy(rng.normal(size=c) * 0.3).to("cuda", torch.float32)
    dy = torch.from_numpy(rng.normal(size=shape)).to("cuda", dtype)
    with torch.no_grad():
        _, mean, rstd = torch_in._cuda_forward(x, scale, bias, 1e-5, 0.01, group)
    return x, scale, bias, mean, rstd, dy


def _of_max(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
# (2, 7, 9, 6): C not a multiple of a 16-byte vector, the scalar path;
# (1, 100, 100, 32): H·W = 10000 is not a multiple of the 1024-pixel chunk;
# (2, 20, 20, 96) with group 4: C = 24 per q block. The fused kernel takes
# (2, 128, 128, 128) (level 2 at full width, 33 pieces a pair) and (4, 64,
# 64, 256); the two-pass kernel level 0 at full width (2, 512, 512, 32),
# (2, 256, 256, 128) with group 4 and (1, 1024, 1024, 32), which the fused
# kernel's rings could not hold (kernels/instance_norm.py::bwd_plan).
@pytest.mark.parametrize("shape,group", [((2, 64, 64, 32), 1), ((2, 16, 16, 512), 1),
                                         ((2, 7, 9, 6), 1), ((1, 100, 100, 32), 1),
                                         ((2, 33, 31, 24), 1), ((2, 32, 32, 64), 4),
                                         ((2, 20, 20, 96), 4), ((2, 128, 128, 128), 1),
                                         ((4, 64, 64, 256), 1), ((2, 512, 512, 32), 1),
                                         ((2, 256, 256, 128), 4), ((1, 1024, 1024, 32), 1)])
def test_instance_norm_backward(dtype, shape, group):
    _need_cuda()
    x, scale, bias, mean, rstd, dy = _k1_backward_case(shape, group, DTYPES[dtype])
    before = torch_in.fused_instance_norm.backward_launches
    got = torch_in._cuda_backward(x, scale, bias, mean, rstd, dy, 0.01, group)
    assert torch_in.fused_instance_norm.backward_launches == before + 1
    want = torch_in._torch_backward(x, scale, bias, mean, rstd, dy, 0.01, group)
    assert got[0].dtype == x.dtype and got[0].shape == x.shape
    assert got[1].shape == got[2].shape == (shape[-1] // group,)
    for name, g, w in zip(("dscale", "dbias"), got[1:], want[1:]):
        assert g.dtype == torch.float32 and _of_max(g, w) <= 1e-4, name
    if dtype == "f32":
        assert _of_max(got[0], want[0]) <= 1e-4
    else:
        dx, dx_want = (v.float().cpu().numpy() for v in (got[0], want[0]))
        assert bf16_ulps(dx, dx_want, 1e-4).max() <= 1.0


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape,group", [((2, 128, 128, 128), 1), ((3, 64, 64, 128), 4),
                                         ((2, 512, 512, 32), 1)])
def test_instance_norm_backward_repeats_bitwise(dtype, shape, group):
    """A second call repeats dx, dscale and dbias bit for bit (no atomic
    touches a sum), also after a call on other inputs of the same shape has
    left its partial sums in the scratch, and both calls match the plain
    version."""
    _need_cuda()
    first = _k1_backward_case(shape, group, DTYPES[dtype], seed=11)
    other = _k1_backward_case(shape, group, DTYPES[dtype], seed=12)
    got = torch_in._cuda_backward(*first, 0.01, group)
    between = torch_in._cuda_backward(*other, 0.01, group)
    again = torch_in._cuda_backward(*first, 0.01, group)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    for case, result in ((first, got), (other, between)):
        want = torch_in._torch_backward(*case, 0.01, group)
        for g, w in zip(result[1:], want[1:]):
            assert _of_max(g, w) <= 1e-4
        if dtype == "f32":
            assert _of_max(result[0], want[0]) <= 1e-4
        else:
            dx, dx_want = (v.float().cpu().numpy() for v in (result[0], want[0]))
            assert bf16_ulps(dx, dx_want, 1e-4).max() <= 1.0


@pytest.fixture
def one_rank_space_group(monkeypatch):
    """A process group of this process alone (NCCL, joined from a
    torchrun-style environment) and a space group of its one rank."""
    import socket

    from unet_implementations_tpu_torch.parallel import distributed

    _need_cuda()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    for key, value in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                       "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}.items():
        monkeypatch.setenv(key, value)
    assert distributed.maybe_initialize_distributed()
    try:
        yield torch.distributed.new_group([0])
    finally:
        distributed.shutdown()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape,group", [((2, 64, 64, 32), 1), ((2, 128, 128, 128), 1),
                                         ((2, 32, 32, 64), 4), ((2, 7, 9, 6), 1)])
def test_instance_norm_split_over_one_rank(dtype, shape, group, one_rank_space_group):
    """Under a space group of one rank, the split forward (statistics without
    their finalize, the all-reduce, the finalize, the apply) gives the
    one-launch forward's statistics to float32 rounding (its chunk sums are
    added in another order) and its y within K1's tolerance; the split
    backward (the two-pass kernel in two calls around the all-reduce, also
    where ``bwd_plan`` picks the fused kernel) gives the two-pass kernel's
    dx, dscale and dbias bit for bit. Each counts one launch and one split."""
    x, scale, bias, _, _, dy = _k1_backward_case(shape, group, DTYPES[dtype])
    fn = torch_in.fused_instance_norm
    before = (fn.launches, fn.split_launches, fn.backward_launches, fn.split_backward_launches)
    with torch.no_grad():
        y, mean, rstd = torch_in._cuda_forward(x, scale, bias, 1e-5, 0.01, group,
                                               one_rank_space_group)
        want_y, want_mean, want_rstd = torch_in._cuda_forward(x, scale, bias, 1e-5, 0.01, group)
    for got, want in ((mean, want_mean), (rstd, want_rstd)):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    if dtype == "f32":
        torch.testing.assert_close(y, want_y, rtol=1e-4, atol=1e-4)
    else:
        assert bf16_ulps(y.float().cpu().numpy(), want_y.float().cpu().numpy(), 1e-4).max() <= 1
    split = torch_in._cuda_backward(x, scale, bias, mean, rstd, dy, 0.01, group,
                                    one_rank_space_group)
    two_pass = torch_in._two_pass_backward(x, scale, bias, mean, rstd, dy, torch.empty_like(x),
                                           0.01, group, torch.cuda.current_stream().cuda_stream)
    for a, b in zip(split, two_pass):
        assert torch.equal(a, b)
    after = (fn.launches, fn.split_launches, fn.backward_launches, fn.split_backward_launches)
    assert [a - b for a, b in zip(after, before)] == [2, 1, 2, 1]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_instance_norm_backward_noncontiguous_dy(dtype):
    """A dy that is not contiguous (a slice of a concat's gradient, the
    broadcast cotangent of a sum) gives what its contiguous copy gives."""
    _need_cuda()
    x, scale, bias, mean, rstd, _ = _k1_backward_case((2, 24, 20, 32), 1, DTYPES[dtype])
    wide = torch.randn((2, 24, 20, 96), device="cuda").to(x.dtype)
    dy = wide[..., 32:64]
    args = (x, scale, bias, mean, rstd)
    strided = torch_in._cuda_backward(*args, dy, 0.01, 1)
    dense = torch_in._cuda_backward(*args, dy.contiguous(), 0.01, 1)
    for a, b in zip(strided, dense):
        assert torch.equal(a, b)
    ones = torch.ones((), device="cuda", dtype=x.dtype).expand_as(x)
    for a, b in zip(torch_in._cuda_backward(*args, ones, 0.01, 1),
                    torch_in._cuda_backward(*args, ones.contiguous(), 0.01, 1)):
        assert torch.equal(a, b)


def test_s2d_eval_with_grad_runs_the_module_path():
    """An s2d model in eval mode with grad enabled (as Grad-CAM runs it)
    takes no fused tail: the backward runs, through K1's backward kernel."""
    _need_cuda()
    model = unet_6stage(dtype=torch.bfloat16, device="cuda", **S2D_LAYOUT).eval()
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(1, 64, 64, 3))).float().cuda()
    k3, k1_bwd = torch_region.fused_s2d_tail.launches, torch_in.fused_instance_norm.backward_launches
    model(x).sum().backward()
    assert torch_region.fused_s2d_tail.launches == k3
    assert torch_in.fused_instance_norm.backward_launches - k1_bwd == 22
    assert all(bool(torch.isfinite(p.grad).all()) for p in model.parameters())


def test_s2d_eval_at_a_width_k3_does_not_take():
    _need_cuda()
    model = UNet(features_per_stage=(48, 64, 64), strides=(1, 2, 2), s2d_level0=True,
                 dtype=torch.bfloat16).cuda().eval()
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(1, 64, 64, 3))).float().cuda()
    k3 = torch_region.fused_s2d_tail.launches
    with torch.no_grad():
        out = model(x)
    assert torch_region.fused_s2d_tail.launches == k3
    assert out.shape == (1, 64, 64, 3) and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("fn", [upsample2x_nhwc_fast, upsample2x_into_s2d_fast])
def test_upsample_grad_bitwise(fn):
    _need_cuda()
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 16, 16, 64))).to(
        torch.bfloat16)
    grads = []
    for device in ("cpu", "cuda"):
        xd = x.to(device).requires_grad_()
        y = fn(xd)
        (g,) = torch.autograd.grad(y, xd, torch.ones_like(y) * 0.3)
        grads.append(g.cpu())
    assert torch.equal(grads[0], grads[1])


def _wino_case(n, height, width, cin, cout, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((n, height // 2, width // 2, 4 * cin), generator=g, device="cuda").to(dtype)
    w = torch.randn((cout, cin, 3, 3), generator=g, device="cuda") * (2 / (9 * cin)) ** 0.5
    b = torch.randn(cout, generator=g, device="cuda")
    return x, w, b


def _direct_s2d(x, w, b):
    xd = depth_to_space(x.float()).permute(0, 3, 1, 2)
    return space_to_depth(torch.nn.functional.conv2d(xd, w, b, padding=1).permute(0, 2, 3, 1))


@pytest.mark.parametrize("folded", [False, True], ids=["unfolded", "folded"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
# Dense (N, H, W, Cin) and Cout. (1, 20, 28): 140 tiles, not a multiple of
# the bf16 kernel's 64; Cin 1024 -> 512 and 512 -> 1024 are decoder_0's
# forward and dx; Cin 256 is 16 chunks of 16 channels, eight turns of its
# 2-stage ring (Cin 128 four).
@pytest.mark.parametrize("shape", [(2, 16, 16, 128, 128), (1, 32, 32, 256, 128),
                                   (1, 16, 16, 128, 384), (1, 20, 28, 128, 128),
                                   (1, 16, 16, 1024, 512), (1, 16, 16, 512, 1024)])
def test_winograd(shape, dtype, folded, monkeypatch):
    _need_cuda()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(winograd, "_FOLDED", folded)
    x, w, b = _wino_case(*shape, DTYPES[dtype])
    tw = winograd.transform_weights_folded if folded else winograd.transform_weights
    u = tw(w).to(x.dtype)
    counter = "launches_folded" if folded else "launches"
    before = getattr(winograd.winograd_conv_s2d, counter)
    got = winograd.winograd_conv_s2d(x, w, b)
    assert getattr(winograd.winograd_conv_s2d, counter) == before + 1
    plain = winograd._torch_winograd_s2d(x, u, b)
    ref = _direct_s2d(x, w, b)
    scale = float(ref.abs().max())
    if dtype == "f32":
        assert float((got - plain).abs().max()) <= 1e-4 * scale
        assert float((got - ref).abs().max()) <= 1e-4 * scale
    else:
        rel_k = float((got.float() - ref).norm() / ref.norm())
        rel_p = float((plain.float() - ref).norm() / ref.norm())
        assert rel_k <= 1.25 * rel_p


def test_winograd_grads(monkeypatch):
    _need_cuda()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    x, w, b = _wino_case(2, 16, 16, 128, 256, torch.float32, seed=1)
    args = [t.clone().requires_grad_() for t in (x, w, b)]
    ref_args = [t.clone().requires_grad_() for t in (x, w, b)]
    before = winograd.winograd_conv_s2d.launches
    y = winograd.winograd_conv_s2d(*args)
    (y * y).sum().backward()
    assert winograd.winograd_conv_s2d.launches == before + 2  # forward, then dx
    (_direct_s2d(*ref_args) ** 2).sum().backward()
    for got, want in zip(args, ref_args):
        assert float((got.grad - want.grad).abs().max()) <= 1e-4 * float(want.grad.abs().max())


def test_winograd_refuses_ineligible():
    _need_cuda()
    x = torch.zeros((1, 4, 4, 4 * 64), device="cuda")
    with pytest.raises(ValueError, match="not eligible"):
        winograd.winograd_conv_s2d(x, torch.zeros((64, 64, 3, 3), device="cuda"),
                                   torch.zeros(64, device="cuda"))


@pytest.mark.parametrize("layout", ["dense", "s2d"])
def test_train_step_runs_the_kernels(layout):
    """A train step of a narrow 6-stage model launches K1 and K2 (22/5 dense,
    22/3/2 s2d: training takes no fused tail, so the s2d blocks run K1 for
    both their norms), no K3, and 22 K1 backwards on the card, none on the
    CPU, and its loss is finite."""
    _need_cuda()
    flags = {"s2d_level0": True, "s2d_low_channel_decoders": True} if layout == "s2d" else {}
    batch = as_uint8(synthetic_batch(0, 2, 64))
    counts = {}
    losses = {}
    for device in ("cpu", "cuda"):
        model = UNet(features_per_stage=(8, 32, 16, 16, 16, 16), **flags).to(device)
        step = steps.make_segmentation_train_step(model, train_state.sgd_nesterov(
            model.parameters()))
        wrappers = (torch_in.fused_instance_norm, upsample2x_nhwc_fast, upsample2x_into_s2d_fast,
                    torch_region.fused_s2d_tail)

        def read():
            return ([w.launches for w in wrappers]
                    + [torch_in.fused_instance_norm.backward_launches])

        before = read()
        losses[device] = float(step(batch, torch.Generator(device).manual_seed(0)))
        counts[device] = [a - b for a, b in zip(read(), before)]
    want = [22, 5, 0, 0, 22] if layout == "dense" else [22, 3, 2, 0, 22]
    assert counts == {"cpu": [0, 0, 0, 0, 0], "cuda": want}
    assert np.isfinite(losses["cuda"])


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


def test_predict_arrays_runs_the_s2d_kernels():
    """The s2d layout (level 0 and decoder_3) launches 16 K1, 3 K2a, 2 K2b and
    3 K3 per forward."""
    _need_cuda()
    model = UNet(features_per_stage=(8, 32, 16, 16, 16, 16), dtype=torch.bfloat16,
                 s2d_level0=True, s2d_low_channel_decoders=True).cuda().eval()
    images = np.random.default_rng(2).integers(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    wrappers = (torch_in.fused_instance_norm, upsample2x_nhwc_fast, upsample2x_into_s2d_fast,
                torch_region.fused_s2d_tail)
    before = [w.launches for w in wrappers]
    masks = predict_arrays(model, images, [(30, 40), (64, 64)])
    assert [w.launches - b for w, b in zip(wrappers, before)] == [16, 3, 2, 3]
    assert [m.shape for m in masks] == [(30, 40), (64, 64)]
    assert set(np.unique(np.concatenate([m.ravel() for m in masks]))) <= {0, 1, 2}


def test_to_device_copies_through_pinned_memory():
    """A host batch reaches the card unchanged, from numpy and from a tensor,
    and a tensor already on the card stays where it is."""
    _need_cuda()
    device = torch.device("cuda")
    host = np.random.default_rng(3).integers(0, 256, (2, 8, 8, 3)).astype(np.uint8)
    for value in (host, torch.from_numpy(host)):
        moved = steps.to_device(value, device)
        assert moved.device.type == "cuda" and moved.dtype == torch.uint8
        np.testing.assert_array_equal(moved.cpu().numpy(), host)
    assert steps.to_device(moved, device) is moved


@pytest.mark.parametrize("size_average", [False, True])
def test_ssim_ignores_tf32(size_average, monkeypatch):
    """cuDNN runs float32 convs in TF32 by default; SSIM's blur must not, as
    JAX's runs at Precision.HIGHEST. With TF32 allowed, the card's SSIM
    equals a float64 computation on the CPU to 1e-5."""
    _need_cuda()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    rng = np.random.default_rng(11)
    a = rng.random((4, 64, 64, 3))
    b = np.clip(a + 0.1 * rng.normal(size=a.shape), 0, 1)
    got = ssim(torch.from_numpy(a).float().cuda(), torch.from_numpy(b).float().cuda(),
               size_average=size_average).cpu().numpy()
    want = _ssim_map_f64(a, b)
    want = want.mean() if size_average else want.mean(axis=(1, 2, 3))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _ssim_map_f64(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The SSIM map of NHWC images in float64 on the CPU: the 11x11 sigma-1.5
    Gaussian window as one zero-padded depthwise conv."""
    coords = torch.arange(11, dtype=torch.float64) - 5.0
    g = torch.exp(-(coords ** 2) / (2 * 1.5 ** 2))
    g = g / g.sum()
    win = torch.outer(g, g).view(1, 1, 11, 11).repeat(3, 1, 1, 1)

    def blur(x):
        return torch.nn.functional.conv2d(x, win, padding=5, groups=3)

    at, bt = (torch.from_numpy(v).permute(0, 3, 1, 2) for v in (a, b))
    mu_a, mu_b = blur(at), blur(bt)
    var_a, var_b = blur(at * at) - mu_a ** 2, blur(bt * bt) - mu_b ** 2
    cov = blur(at * bt) - mu_a * mu_b
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2))
    return m.permute(0, 2, 3, 1).numpy()


def _narrow(head="segmentation"):
    return UNet(features_per_stage=(8, 32, 16, 16, 16, 16), head=head)


def _step_counts(step, batch, device):
    wrappers = (torch_in.fused_instance_norm, upsample2x_nhwc_fast)

    def read():
        return [w.launches for w in wrappers] + [torch_in.fused_instance_norm.backward_launches]

    before = read()
    loss = float(step(batch, torch.Generator(device).manual_seed(0)))
    return [a - b for a, b in zip(read(), before)], loss


def test_reconstruction_and_transfer_steps_run_the_kernels():
    """An autoencoder train step launches K1/K2a/K1bwd 22/5/22, like the
    segmentation step. With the encoder frozen and the input taking no
    gradient, autograd records nothing in the encoder: the transfer step
    launches K1bwd for the 10 decoder norms only, and leaves the encoder
    unchanged."""
    _need_cuda()
    pixels = as_uint8(synthetic_batch(0, 2, 64))["image"]
    ae = _narrow("reconstruction").cuda()
    counts, loss = _step_counts(steps.make_reconstruction_train_step(
        ae, train_state.adam_l2(ae.parameters())), {"image": pixels, "target": pixels}, "cuda")
    assert counts == [22, 5, 22] and np.isfinite(loss)

    model = _narrow().cuda()
    encoder = {k: v for k, v in ae.state_dict().items() if k.startswith("encoder_stages.")}
    model.load_state_dict(encoder, strict=False)
    train_state.with_frozen(model, ["encoder_stages"])
    step = steps.make_segmentation_train_step(model, train_state.sgd_nesterov(
        [p for p in model.parameters() if p.requires_grad]))
    counts, loss = _step_counts(step, as_uint8(synthetic_batch(1, 2, 64)), "cuda")
    assert counts == [22, 5, 10] and np.isfinite(loss)
    for k, v in encoder.items():
        assert torch.equal(model.state_dict()[k], v), k


def _all_counts():
    wrappers = (torch_in.fused_instance_norm, upsample2x_nhwc_fast, upsample2x_into_s2d_fast,
                torch_region.fused_s2d_tail)
    return [w.launches for w in wrappers] + [torch_in.fused_instance_norm.backward_launches]


def _counted(fn):
    before = _all_counts()
    out = fn()
    return [a - b for a, b in zip(_all_counts(), before)], out


@pytest.mark.parametrize("layout", ["dense", "s2d"])
def test_clip_fusion_runs_the_kernels(layout):
    """The CLIP-fused model's fusion norm is one more K1 per forward and one
    more K1bwd per step: forwards 23/5/0/0 dense and 17/3/2/3 s2d (22/5/0/0
    dense without features), a ``use_clip`` train step 23/5/0/0/23 dense and
    23/3/2/0/23 s2d; on the CPU none."""
    _need_cuda()
    flags = {"s2d_level0": True, "s2d_low_channel_decoders": True} if layout == "s2d" else {}
    batch = as_uint8(synthetic_batch(0, 2, 64))
    batch["clip_features"] = np.random.default_rng(1).normal(size=(2, 24)).astype(np.float32)
    model = UNet(features_per_stage=(8, 32, 16, 16, 16, 16), clip_fusion=True, clip_dim=24,
                 dtype=torch.bfloat16, **flags).cuda().eval()
    x = torch.from_numpy(batch["image"]).cuda()
    cf = torch.from_numpy(batch["clip_features"]).cuda()
    with torch.inference_mode():
        fused, out = _counted(lambda: model(x.float(), cf))
        unfused, plain = _counted(lambda: model(x.float()))
    assert fused[:4] == ([23, 5, 0, 0] if layout == "dense" else [17, 3, 2, 3])
    if layout == "dense":
        assert unfused[:4] == [22, 5, 0, 0]
    assert torch.isfinite(out).all() and not torch.equal(out, plain)
    step = steps.make_segmentation_train_step(model, train_state.sgd_nesterov(
        model.parameters()), use_clip=True)
    counts, loss = _counted(lambda: float(step(batch, torch.Generator("cuda").manual_seed(0))))
    assert counts == ([23, 5, 0, 0, 23] if layout == "dense" else [23, 3, 2, 0, 23])
    assert np.isfinite(loss)
    cpu = model.cpu()
    step = steps.make_segmentation_train_step(cpu, train_state.sgd_nesterov(cpu.parameters()),
                                              use_clip=True)
    counts, _ = _counted(lambda: float(step(batch, torch.Generator().manual_seed(0))))
    assert counts == [0, 0, 0, 0, 0]


def test_clip_tower_on_cuda_launches_no_kernel():
    """The ViT tower is plain torch: on the card it launches none of the
    port's kernels, and its float32 embeddings (TF32 off) equal the CPU's to
    1e-5 relative L2; a bf16 call repeats bit for bit."""
    _need_cuda()
    config = clip.CLIPVisionConfig(image_size=32, patch_size=16, width=64, layers=2, heads=2,
                                   output_dim=16)
    tower = clip.CLIPVisionTransformer(config, generator=torch.Generator().manual_seed(2))
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(4, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        want = tower(x)
        counts, got = _counted(lambda: tower.cuda()(x.cuda()))
        tower.dtype = torch.bfloat16
        a, b = tower(x.cuda()), tower(x.cuda())
    assert counts == [0, 0, 0, 0, 0]
    assert float((got.cpu() - want).norm() / want.norm()) <= 1e-5
    assert a.dtype == torch.float32 and torch.equal(a, b)


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def test_accum_step_matches_its_sequential_oracle(monkeypatch):
    """The accumulated step with the kernels (b4 at 64² as 2 microbatches,
    float32, dropout on) against its contract spelled out with the same
    kernels: two plain forward and backward passes of ``batch[i::2]`` with
    ``microbatch_generator``'s dropout, the gradients summed in float32 and
    halved, one update. Loss and parameters to 1e-4 relative (cuDNN
    deterministic); launches K1/K2a/K1bwd 44/10/44, twice the plain step's."""
    _need_cuda()
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    batch = {k: torch.from_numpy(v).cuda() for k, v in as_uint8(synthetic_batch(3, 4, 64)).items()}
    state = _narrow().cuda().state_dict()
    loss_fn = steps.make_segmentation_loss_fn()

    model = _narrow().cuda()
    model.load_state_dict(state)
    step = steps.make_accum_train_step(model, train_state.sgd_nesterov(model.parameters()),
                                       loss_fn, 2)
    counts, loss = _counted(lambda: float(step(batch, torch.Generator("cuda").manual_seed(4))))
    assert counts == [44, 10, 0, 0, 44]

    oracle = _narrow().cuda()
    oracle.load_state_dict(state)
    optimizer = train_state.sgd_nesterov(oracle.parameters())
    gen = torch.Generator("cuda").manual_seed(4)
    params = list(oracle.parameters())
    sums = [torch.zeros_like(p) for p in params]
    losses = []
    oracle.train()
    for i in range(2):
        oracle.zero_grad(set_to_none=True)
        micro = {k: v[i::2].contiguous() for k, v in batch.items()}
        micro_loss = loss_fn(oracle, micro, steps.microbatch_generator(gen, i))
        micro_loss.backward()
        for acc, p in zip(sums, params):
            acc += p.grad
        losses.append(float(micro_loss.detach()))
    for acc, p in zip(sums, params):
        p.grad = acc / 2
    optimizer.step()
    assert abs(loss - np.mean(losses)) <= 1e-4 * abs(np.mean(losses))
    want = oracle.state_dict()
    for key, value in model.state_dict().items():
        assert _rel_l2(value, want[key]) <= 1e-4, key


def test_ddp_step_at_world_size_one_over_nccl(monkeypatch):
    """The ``DistributedDataParallel`` step over NCCL at world size 1 (the
    group joined from a torchrun-style environment) equals the plain step:
    its loss reduces its class counts and CE denominator over one rank, and
    DDP averages over one rank."""
    _need_cuda()
    import socket

    from unet_implementations_tpu_torch.parallel import distributed, mesh

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    for key, value in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                       "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}.items():
        monkeypatch.setenv(key, value)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    batch = as_uint8(synthetic_batch(5, 2, 64))
    state = _narrow().cuda().state_dict()

    def one_step(wrap: bool):
        model = _narrow().cuda()
        model.load_state_dict(state)
        trained = mesh.wrap(model) if wrap else model
        step = steps.make_segmentation_train_step(trained, train_state.sgd_nesterov(
            model.parameters()))
        counts, loss = _counted(lambda: float(step(batch, torch.Generator("cuda").manual_seed(6))))
        assert counts == [22, 5, 0, 0, 22]
        return loss, model.state_dict()

    assert distributed.maybe_initialize_distributed()
    try:
        assert torch.distributed.get_backend() == "nccl"
        assert mesh.create_mesh() is None  # one rank: no data parallelism in the recipes
        ddp_loss, ddp = one_step(wrap=True)
    finally:
        distributed.shutdown()
    loss, plain = one_step(wrap=False)
    assert abs(ddp_loss - loss) <= 1e-6 * abs(loss)
    for key, value in ddp.items():
        assert _rel_l2(value, plain[key]) <= 1e-6, key


@pytest.mark.parametrize("fp8", [torch.float8_e5m2, torch.float8_e4m3fn])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_fp8_cast_bitwise(dtype, fp8):
    _need_cuda()
    bits = torch.arange(65536, dtype=torch.int32).to(torch.int16).view(dtype)
    got = k8.fp8_bits(bits.to("cuda"), fp8).cpu()
    assert torch.equal(got, k8.fp8_bits_plain(bits, fp8))


@pytest.mark.parametrize("fp8", [torch.float8_e5m2, torch.float8_e4m3fn])
@pytest.mark.parametrize("shape,k,stride,padding", [
    ((2, 17, 23, 3, 8), 3, 1, (1, 1, 1, 1)), ((2, 16, 16, 24, 40), 3, 2, (1, 1, 1, 1)),
    ((1, 12, 12, 12, 70), 5, 1, (2, 2, 2, 2)), ((2, 9, 9, 64, 32), 2, 1, (1, 0, 1, 0)),
    ((2, 10, 12, 32, 12), 1, 1, (0, 0, 0, 0)), ((1, 11, 8, 16, 16), 3, 1, (0, 0, 1, 1)),
    # The wgmma kernel's edges: stride 2 at odd sizes and B = 3, 5x5 at both
    # strides, W = 16 and 40, one and several N-tiles (Cout 32, 96, 128,
    # 256), Cin of several chunks, 1x1, and the s2d transforms' paddings.
    ((3, 15, 13, 32, 32), 3, 2, (1, 1, 1, 1)), ((2, 9, 9, 32, 32), 3, 2, (1, 0, 1, 0)),
    ((2, 19, 17, 64, 64), 5, 1, (2, 2, 2, 2)), ((1, 21, 23, 32, 64), 5, 2, (2, 2, 2, 2)),
    ((2, 16, 16, 64, 128), 3, 1, (1, 1, 1, 1)), ((1, 40, 40, 32, 256), 3, 1, (1, 1, 1, 1)),
    ((2, 12, 12, 96, 96), 2, 1, (1, 0, 1, 0)), ((2, 10, 12, 32, 64), 1, 1, (0, 0, 0, 0)),
    ((3, 16, 40, 128, 32), 3, 1, (1, 1, 1, 1))])
def test_fp8_conv(shape, k, stride, padding, fp8):
    _need_cuda()
    b, h, w, cin, cout = shape
    g = torch.Generator(device="cuda").manual_seed(cin + cout)
    x = torch.randn((b, h, w, cin), generator=g, device="cuda").to(torch.bfloat16)
    wt = (torch.randn((cout, cin, k, k), generator=g, device="cuda") * 0.2).to(torch.bfloat16)
    wgmma = k8.wgmma_applicable(x.shape, wt.shape, stride, padding)
    assert wgmma == (cin % 32 == 0 and cout % 32 == 0)
    before = (k8.fp8_conv.launches, k8.fp8_conv.wgmma_launches)
    got = k8.fp8_conv(x, wt, None, None, stride, padding, fp8)
    assert (k8.fp8_conv.launches, k8.fp8_conv.wgmma_launches) == (before[0] + 1,
                                                                  before[1] + wgmma)
    assert got.shape == k8.output_size(x.shape, wt.shape, stride, padding)

    xq, wq = (k8.fp8_values(k8.fp8_bits_plain(a.cpu(), fp8), fp8).double() for a in (x, wt))
    t, bo, le, r = padding

    def conv(a, ww):
        return torch.nn.functional.conv2d(torch.nn.functional.pad(
            a.permute(0, 3, 1, 2), (le, r, t, bo)), ww, stride=stride).permute(0, 2, 3, 1)

    exact, absum = conv(xq, wq), conv(xq.abs(), wq.abs())
    spacing = torch.exp2(torch.floor(torch.log2(exact.abs().clamp_min(2.0 ** -126))) - 7)
    err = (got.double().cpu() - exact).abs()
    assert bool((err <= spacing + cin * k * k * 2.0 ** -24 * absum).all())
    # chip_smoke.py phase 16 (a)'s gate: within one bf16 ulp of the plain
    # version, or else (where float32 sums cancel) of the exact sum as above.
    plain = k8._plain_conv(x, wt, None, None, stride, padding, fp8).double().cpu()
    far = (got.double().cpu() - plain).abs() > spacing
    assert int(far.sum()) <= 4096
    assert torch.equal(got, k8.fp8_conv(x, wt, None, None, stride, padding, fp8))


@pytest.mark.parametrize("fp8", [torch.float8_e5m2, torch.float8_e4m3fn])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_fp8_conv_wgmma_epilogue(dtype, fp8):
    """The wgmma kernel with a residual and a bias: ((conv rounded) +
    residual, rounded) + bias, rounded, each in x's dtype, bit for bit from
    the kernel's own conv; its packed weights bit for bit the plain pack."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((2, 16, 40, 64), generator=g, device="cuda").to(dtype)
    wt = (torch.randn((64, 64, 3, 3), generator=g, device="cuda") * 0.05).to(dtype)
    bias = (torch.randn(64, generator=g, device="cuda") * 0.1).to(dtype)
    res = torch.randn((2, 16, 40, 64), generator=g, device="cuda").to(dtype)
    plan = k8.wgmma_plan(x.shape, wt.shape, 1, (1, 1, 1, 1))
    assert plan is not None
    assert torch.equal(k8.pack_weight(wt, fp8, plan.bn).view(torch.int16).cpu(),
                       k8.pack_weight_plain(wt.cpu(), fp8, plan.bn).view(torch.int16))
    before = k8.fp8_conv.wgmma_launches
    conv = k8.fp8_conv(x, wt, None, None, 1, (1, 1, 1, 1), fp8)
    got = k8.fp8_conv(x, wt, bias, res, 1, (1, 1, 1, 1), fp8)
    assert k8.fp8_conv.wgmma_launches == before + 2
    assert torch.equal(got, (res + conv) + bias)
    assert torch.equal(got, k8.fp8_conv(x, wt, bias, res, 1, (1, 1, 1, 1), fp8))


def test_fp8_mode_raises_under_autograd(monkeypatch):
    _need_cuda()
    from unet_implementations_tpu_torch.ops import quant

    monkeypatch.setenv("UNET_TPU_CONV_FP8", "all")
    x = torch.zeros((1, 8, 8, 8), device="cuda", dtype=torch.bfloat16).permute(0, 3, 1, 2)
    w = torch.zeros((8, 8, 3, 3), device="cuda", dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(NotImplementedError, match="forward-only"):
        quant.qconv(x, w, None, 1, 1)
