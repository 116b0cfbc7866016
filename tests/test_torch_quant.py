"""The port's fp8 conv mode (``ops/quant.py``, ``kernels/fp8_conv.py``) against JAX's.

On the CPU ``qconv`` runs the fp8 conv's plain version, which these tests
hold to ``unet_implementations_tpu/ops/quant.py`` on the same numpy inputs:

- the policy's parsing, as ``tests/test_fp8_mode.py`` pins JAX's;
- the fp8 cast bit for bit JAX's ``astype`` on every bf16 and fp16 value
  (subnormals, ±inf, NaNs, the range past 448 and 57344 on both signs);
- ``qconv`` at each kind of site the model has (dense k = 1, 3, 5 at stride
  1 and 2, ``conv_s2d``, ``conv_s2d_multi``, ``conv_s2d_to_dense_stride2``),
  in both fp8 dtypes, every element within one bf16 ulp of JAX's: the fp8
  products are exact in float32 and only the float32 sums' order differs;
- a conv below the policy's grid bit for bit the policy-off call, the raise
  under autograd, and the parameters untouched by the policy;
- the whole ``unet_6stage`` at 64² bf16 in both layouts against JAX's fp8
  model at ``tests/test_fp8_mode.py``'s bounds (finite, drift above 0, the
  selective policy drifting less than ``all``, drift under 2 logit stds), and
  the port's fp8 argmax agreeing with JAX's fp8 argmax at least as often as
  JAX's fp8 agrees with JAX's bf16;
- ``torch.export`` of a model under the policy: ``unet_torch::fp8_conv``
  nodes, replayed bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_implementations_tpu.models import s2d as jax_s2d
from unet_implementations_tpu.models.unet import UNet as JaxUNet
from unet_implementations_tpu.ops import quant as jax_quant
from unet_implementations_tpu_torch.kernels import fp8_conv as k8
from unet_implementations_tpu_torch.models import convert
from unet_implementations_tpu_torch.models.unet import S2D_LAYOUT, UNet
from unet_implementations_tpu_torch.ops import quant, s2d

FP8 = {"e5m2": (torch.float8_e5m2, jnp.float8_e5m2),
       "e4m3": (torch.float8_e4m3fn, jnp.float8_e4m3fn)}
DENSE = {"s2d_level0": False, "s2d_low_channel_decoders": False}


@pytest.fixture
def clean_env(monkeypatch):
    for var in ("UNET_TPU_CONV_FP8", "UNET_TPU_CONV_FP8_DTYPE"):
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


def _policy(env, grid="all", fp8="e5m2"):
    env.setenv("UNET_TPU_CONV_FP8", grid)
    env.setenv("UNET_TPU_CONV_FP8_DTYPE", fp8)


def _bf16_ulps(a, b) -> np.ndarray:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    mag = np.maximum(np.maximum(np.abs(a), np.abs(b)), np.float32(2.0 ** -126))
    return np.abs(a - b) / np.exp2(np.floor(np.log2(mag)) - 7)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


class TestPolicy:
    def test_default_off(self, clean_env):
        assert quant.fp8_conv_min_grid() is None

    @pytest.mark.parametrize("val,want", [
        ("off", None), ("", None), ("false", None), ("none", None),
        ("all", 0), ("0", 0), ("128", 128), ("192", 192),
        ("garbage", None),
    ])
    def test_min_grid_values(self, clean_env, val, want):
        clean_env.setenv("UNET_TPU_CONV_FP8", val)
        assert quant.fp8_conv_min_grid() == want == jax_quant.fp8_conv_min_grid()

    def test_dtype_picker(self, clean_env):
        assert quant.fp8_conv_dtype() == torch.float8_e5m2
        for name in ("e4m3", "fp8_e4m3", "float8_e4m3fn"):
            clean_env.setenv("UNET_TPU_CONV_FP8_DTYPE", name)
            assert quant.fp8_conv_dtype() == torch.float8_e4m3fn
        clean_env.setenv("UNET_TPU_CONV_FP8_DTYPE", "e5m2")
        assert quant.fp8_conv_dtype() == torch.float8_e5m2

    def test_quantizes(self, clean_env):
        x = torch.zeros(1, 4, 32, 64, dtype=torch.bfloat16)
        assert not quant.quantizes(x)
        clean_env.setenv("UNET_TPU_CONV_FP8", "32")
        assert quant.quantizes(x) and not quant.quantizes(x.float())
        assert not quant.quantizes(x[:, :, :16])
        # A row shard of 16 rows of a 64-row image: the whole image's grid.
        assert quant.quantizes(x[:, :, :16], rows=64)
        assert quant.quantizes(x.half()) and not quant.quantizes(x.to(torch.int16))


class TestCast:
    @pytest.mark.parametrize("fp8", sorted(FP8))
    @pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
    def test_every_value_bit_for_bit_jax(self, dtype, fp8):
        bits = np.arange(65536, dtype=np.uint32).astype(np.uint16)
        jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float16
        x = bits.view(jdt)
        want = np.asarray(jnp.asarray(x).astype(FP8[fp8][1])).view(np.uint8)
        got = k8.fp8_bits(torch.from_numpy(bits.astype(np.int16)).view(getattr(torch, dtype)),
                          FP8[fp8][0])
        np.testing.assert_array_equal(got.numpy(), want)

    def test_e4m3_nan_above_464_on_both_signs(self):
        x = torch.tensor([448.0, 464.0, 466.0, -464.0, -466.0, float("inf"), -float("inf")],
                         dtype=torch.bfloat16)
        got = k8.fp8_bits(x, torch.float8_e4m3fn).tolist()
        assert got == [0x7E, 0x7E, 0x7F, 0xFE, 0xFF, 0x7F, 0xFF]
        # torch's own cast saturates: the plain version may not be a bare .to().
        assert x.to(torch.float8_e4m3fn).view(torch.uint8).tolist()[2] == 0x7E


def _jax_dense(x, w, b, stride, pad, fp8):
    y = jax_quant.qconv(jnp.asarray(x, jnp.bfloat16),
                        jnp.asarray(np.transpose(w, (2, 3, 1, 0)), jnp.bfloat16),
                        (stride, stride), [(pad, pad), (pad, pad)])
    return y + jnp.asarray(b, jnp.bfloat16).astype(y.dtype)


def _inputs(rng, b, h, c):
    return rng.normal(size=(b, h, h, c)).astype(np.float32)


class TestQconvSites:
    """Each kind of ``qconv`` site against JAX's, both fp8 dtypes."""

    @pytest.mark.parametrize("fp8", sorted(FP8))
    @pytest.mark.parametrize("k,stride,cin,cout", [
        (3, 1, 3, 16), (3, 2, 16, 24), (1, 1, 16, 3), (5, 1, 8, 8), (5, 2, 24, 8),
        (3, 1, 12, 40)])
    def test_dense(self, clean_env, fp8, k, stride, cin, cout):
        _policy(clean_env, "all", fp8)
        rng = np.random.default_rng(k * 10 + stride + cin)
        x = _inputs(rng, 2, 16, cin)
        w = (rng.normal(size=(cout, cin, k, k)) * np.sqrt(2 / (k * k * cout))).astype(np.float32)
        b = (0.1 * rng.normal(size=cout)).astype(np.float32)
        want = np.asarray(_jax_dense(x, w, b, stride, k // 2, fp8).astype(jnp.float32))
        with torch.no_grad():
            got = quant.qconv(_t(x).permute(0, 3, 1, 2), _t(w), _t(b), stride, k // 2)
        got = _np(got.permute(0, 2, 3, 1))
        assert got.shape == want.shape
        assert _bf16_ulps(got, want).max() <= 1.0

    @pytest.mark.parametrize("fp8", sorted(FP8))
    @pytest.mark.parametrize("site", ["conv_s2d", "conv_s2d_multi", "stride2", "conv_s2d_k5",
                                      "conv_s2d_1x1"])
    def test_s2d(self, clean_env, fp8, site):
        _policy(clean_env, "all", fp8)
        rng = np.random.default_rng(len(site))
        k = {"conv_s2d_k5": 5, "conv_s2d_1x1": 1}.get(site, 3)
        segments = (8, 4) if site == "conv_s2d_multi" else (8,)
        cin, cout = sum(segments), 8
        w = (rng.normal(size=(cout, cin, k, k)) * np.sqrt(2 / (k * k * cout))).astype(np.float32)
        b = (0.1 * rng.normal(size=cout)).astype(np.float32)
        xs = [_inputs(rng, 2, 8, 4 * c) for c in segments]
        jw, jb = jnp.asarray(np.transpose(w, (2, 3, 1, 0)), jnp.bfloat16), jnp.asarray(
            b, jnp.bfloat16)
        jx = [jnp.asarray(x, jnp.bfloat16) for x in xs]
        with torch.no_grad():
            if site == "conv_s2d_multi":
                want = jax_s2d.conv_s2d_multi(jx, jw, jb, segments)
                got = s2d.conv_s2d_multi([_t(x) for x in xs], _t(w), _t(b), segments)
            elif site == "stride2":
                want = jax_s2d.conv_s2d_to_dense_stride2(jx[0], jw, jb)
                got = s2d.conv_s2d_to_dense_stride2(_t(xs[0]), _t(w), _t(b))
            else:
                want = jax_s2d.conv_s2d(jx[0], jw, jb)
                got = s2d.conv_s2d(_t(xs[0]), _t(w), _t(b))
        want = np.asarray(want.astype(jnp.float32))
        assert got.shape == want.shape
        assert _bf16_ulps(_np(got), want).max() <= 1.0

    def test_below_min_grid_is_the_plain_call(self, clean_env):
        rng = np.random.default_rng(3)
        x = _t(_inputs(rng, 2, 16, 8)).permute(0, 3, 1, 2)
        w, b = _t(rng.normal(size=(8, 8, 3, 3)) * 0.2), _t(0.1 * rng.normal(size=8))
        with torch.no_grad():
            off = quant.qconv(x, w, b, 1, 1)
            clean_env.setenv("UNET_TPU_CONV_FP8", "17")
            below = quant.qconv(x, w, b, 1, 1)
            clean_env.setenv("UNET_TPU_CONV_FP8", "16")
            at = quant.qconv(x, w, b, 1, 1)
        assert torch.equal(off, below)
        assert not torch.equal(off, at)

    def test_raises_under_autograd(self, clean_env):
        _policy(clean_env)
        x = torch.zeros(1, 4, 8, 8, dtype=torch.bfloat16)
        w = torch.zeros(4, 4, 3, 3, dtype=torch.bfloat16, requires_grad=True)
        with pytest.raises(NotImplementedError, match="forward-only"):
            quant.qconv(x, w, None, 1, 1)
        model = UNet(features_per_stage=(4, 8), strides=(1, 2), encoder_dropout_rates=(0, 0),
                     decoder_dropout_rates=(0,), dtype=torch.bfloat16).eval()
        with pytest.raises(NotImplementedError, match="forward-only"):
            model(torch.zeros(1, 8, 8, 3))
        with torch.no_grad():
            assert model(torch.zeros(1, 8, 8, 3)).shape == (1, 8, 8, 3)

    def test_parameters_unchanged(self, clean_env):
        model = UNet(features_per_stage=(8, 16), strides=(1, 2), dtype=torch.bfloat16).eval()
        before = {k: v.clone() for k, v in model.state_dict().items()}
        _policy(clean_env)
        with torch.no_grad():
            model(torch.randn(1, 16, 16, 3))
        assert all(p.dtype == torch.float32 for p in model.parameters())
        for k, v in model.state_dict().items():
            assert torch.equal(v, before[k]), k


def _kaiming(tree, rng):
    """The JAX init's distribution from numpy: Kaiming-normal fan_out conv
    kernels, zero biases, unit norm scales."""
    out = {}
    for name, node in tree.items():
        if isinstance(node, dict):
            out[name] = _kaiming(node, rng)
        elif name == "kernel":
            kh, kw, _, cout = node.shape
            out[name] = (rng.normal(size=node.shape) * np.sqrt(2.0 / (kh * kw * cout))).astype(
                np.float32)
        else:
            out[name] = np.full(node.shape, name == "scale", np.float32)
    return out


def _logits_jax(jmodel, params, x):
    return np.asarray(jax.jit(lambda p, a: jmodel.apply({"params": p}, a))(
        params, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))


class TestModel:
    @pytest.mark.parametrize("layout", ["s2d", "dense"])
    def test_fp8_model_against_jax(self, clean_env, layout):
        flags = S2D_LAYOUT if layout == "s2d" else DENSE
        jmodel = JaxUNet(dtype=jnp.bfloat16, **flags)
        x = np.random.default_rng(1).uniform(size=(1, 64, 64, 3)).astype(np.float32)
        shapes = jax.eval_shape(jmodel.init, jax.random.key(0),
                                 jnp.asarray(x, jnp.bfloat16))["params"]
        params = _kaiming(shapes, np.random.default_rng(0))
        model = UNet(dtype=torch.bfloat16, **flags).eval()
        model.load_state_dict(convert.params_from_jax(params, model), strict=True)

        def port():
            with torch.no_grad():
                return model(torch.from_numpy(x)).numpy()

        ref, jref = port(), _logits_jax(jmodel, params, x)
        _policy(clean_env, "all", "e4m3")
        got_all, jall = port(), _logits_jax(jmodel, params, x)
        _policy(clean_env, "32", "e4m3")
        got_sel = port()
        assert np.isfinite(got_all).all() and np.isfinite(got_sel).all()
        mad_all = float(np.abs(got_all - ref).mean())
        mad_sel = float(np.abs(got_sel - ref).mean())
        assert mad_all > 0
        assert mad_sel < mad_all
        assert mad_all < 2.0 * float(ref.std())
        agree_port = float((got_all.argmax(-1) == jall.argmax(-1)).mean())
        agree_jax = float((jall.argmax(-1) == jref.argmax(-1)).mean())
        assert agree_port >= agree_jax, (agree_port, agree_jax)

    def test_export_replays_fp8_nodes(self, clean_env, tmp_path):
        from unet_implementations_tpu_torch.serving import export

        model = UNet(features_per_stage=(8, 16, 32), strides=(1, 2, 2), dtype=torch.bfloat16,
                     **S2D_LAYOUT).eval()
        _policy(clean_env)
        program = export.export_forward(model, batch_size=1, img_size=32)
        nodes = [n for n in program.graph.nodes
                 if n.op == "call_function" and "fp8_conv" in str(n.target)]
        x = torch.randn(1, 32, 32, 3).to(torch.bfloat16)
        with torch.no_grad():
            want = model(x)
        clean_env.delenv("UNET_TPU_CONV_FP8")
        # Each encoder and decoder conv, decoder conv_0 as two segments, the head.
        assert len(nodes) == 3 * 2 + 2 * 3 + 1
        assert torch.equal(program.module()(x), want)


def _pack_formula(bits: np.ndarray, bn: int) -> np.ndarray:
    """The wgmma kernel's packed values by their defining index formula:
    value i = ((((((nt·NC + cc)·taps + tap)·2 + k8)·(bn/8) + n8)·8 + nr)·8 + kr
    holds bits[nt·bn + 8·n8 + nr, 16·cc + 8·k8 + kr, tap // kw, tap % kw]."""
    cout, cin, kh, kw = bits.shape
    i = np.arange(bits.size)
    kr, i = i % 8, i // 8
    nr, i = i % 8, i // 8
    n8, i = i % (bn // 8), i // (bn // 8)
    k8, i = i % 2, i // 2
    tap, i = i % (kh * kw), i // (kh * kw)
    cc, nt = i % (cin // 16), i // (cin // 16)
    return bits[nt * bn + 8 * n8 + nr, 16 * cc + 8 * k8 + kr, tap // kw, tap % kw]


def _f16_bits(fp8_bytes: np.ndarray, jfp8) -> np.ndarray:
    """The float16 bits of fp8 values (JAX's), NaN as 0x7e00 with its sign."""
    values = np.asarray(jnp.asarray(fp8_bytes).view(jfp8).astype(jnp.float32))
    half = values.astype(np.float16).view(np.uint16)
    nan = ((fp8_bytes.astype(np.uint16) & 0x80) << 8) | 0x7E00
    return np.where(np.isnan(values), nan, half).astype(np.uint16)


class TestWgmmaPack:
    """``pack_weight_plain`` (what the wgmma kernel's pack writes on the card)
    against the index formula over the float16 of JAX's fp8 cast of the same
    kernel."""

    @pytest.mark.parametrize("fp8", sorted(FP8))
    @pytest.mark.parametrize("cout", [32, 64, 96])
    @pytest.mark.parametrize("cin", [32, 64, 96])
    @pytest.mark.parametrize("k", [1, 2, 3, 5])
    def test_pack_order_against_formula(self, fp8, k, cin, cout):
        rng = np.random.default_rng(1000 * k + 10 * cin + cout)
        w = (rng.normal(size=(cout, cin, k, k)) * 64).astype(np.float32)
        w.flat[:4] = [np.nan, np.inf, -600.0, 70000.0]
        wt = _t(w)
        # The same bf16 values on both sides (the float32 -> bf16 casts of
        # torch and JAX differ on a NaN's sign).
        same = wt.view(torch.int16).numpy().view(jnp.bfloat16)
        jbits = np.asarray(jnp.asarray(same).astype(FP8[fp8][1])).view(np.uint8)
        want = _f16_bits(jbits, FP8[fp8][1])
        for bn in [b for b in k8.WGMMA_TILE_N if cout % b == 0]:
            got = k8.pack_weight_plain(wt, FP8[fp8][0], bn)
            assert got.dtype == torch.float16 and got.numel() == w.size
            np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16),
                                          _pack_formula(want, bn))


_MODELS = {"dense": DENSE, "s2d": S2D_LAYOUT,
           "k5": {**DENSE, "kernel_size": 5, "n_conv_per_stage": 3,
                  "n_conv_per_stage_decoder": 1}}


class TestWgmmaRule:
    """Which kernel takes each fp8 conv call the models make under ``all``."""

    @pytest.mark.parametrize("layout", sorted(_MODELS))
    def test_model_calls(self, clean_env, layout):
        _policy(clean_env)
        calls, real = [], quant.fp8_conv

        def spy(x, w, bias, residual, stride, padding, fp8):
            calls.append((tuple(x.shape), tuple(w.shape), stride, tuple(padding)))
            return real(x, w, bias, residual, stride, padding, fp8)

        clean_env.setattr(quant, "fp8_conv", spy)
        model = UNet(dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0),
                     **_MODELS[layout]).eval()
        with torch.no_grad():
            model(torch.rand(1, 64, 64, 3))
        assert len(calls) == {"dense": 28, "s2d": 28, "k5": 29}[layout]
        general = [c for c in calls if not k8.wgmma_applicable(*c)]
        # The first conv (Cin 3, or 12 in s2d) and the head (Cout 3 or 12).
        assert general == [c for c in calls if c[0][3] in (3, 12) or c[1][0] in (3, 12)]
        assert [calls.index(c) for c in general] == [0, len(calls) - 1]
        # The same calls at 512² and b8, the card's shapes, keep their kernel.
        for x_shape, w_shape, stride, padding in calls:
            big = (8, 8 * x_shape[1], 8 * x_shape[2], x_shape[3])
            assert (k8.wgmma_applicable(big, w_shape, stride, padding)
                    == ((x_shape, w_shape, stride, padding) not in general))

    @pytest.mark.parametrize("x_shape,w_shape,stride,padding,bn", [
        ((2, 9, 9, 64), (32, 64, 2, 2), 1, (1, 0, 1, 0), 32),
        ((1, 40, 40, 32), (256, 32, 3, 3), 1, (1, 1, 1, 1), 128),
        ((8, 512, 512, 32), (32, 32, 3, 3), 1, (1, 1, 1, 1), 32),
        ((8, 32, 32, 512), (512, 512, 3, 3), 1, (1, 1, 1, 1), 128),
        ((8, 512, 512, 32), (64, 32, 5, 5), 2, (2, 2, 2, 2), 32)])
    def test_plan_fits(self, x_shape, w_shape, stride, padding, bn):
        plan = k8.wgmma_plan(x_shape, w_shape, stride, padding)
        assert plan.bn == bn and 1 <= plan.tiles <= 256 // bn
        _, _, offsets = k8.wgmma_geometry(x_shape, w_shape, stride, padding)
        wps = [-(-(128 * plan.tiles + off) // 8) * 8 for off in offsets]
        assert plan.stage_bytes == w_shape[2] * w_shape[3] * 32 * bn + 2 * sum(wps) * 16
        assert (plan.stages * (plan.stage_bytes + 16) + plan.ring * 512 * 16 * 2
                <= k8.SMEM_BYTES)
        assert 2 <= plan.stages <= k8.WGMMA_MAX_STAGES and plan.ring in k8.WGMMA_RINGS

    @pytest.mark.parametrize("x_shape,w_shape,stride", [
        ((1, 8, 8, 3), (32, 3, 3, 3), 1), ((1, 8, 8, 32), (12, 32, 1, 1), 1),
        ((1, 8, 8, 48), (32, 48, 3, 3), 1), ((1, 8, 8, 32), (32, 32, 3, 3), 3)])
    def test_general_shapes(self, x_shape, w_shape, stride):
        assert not k8.wgmma_applicable(x_shape, w_shape, stride, (1, 1, 1, 1))
