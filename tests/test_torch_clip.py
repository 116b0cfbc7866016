"""The port's CLIP tower and CLIP-fused UNet (unet_implementations_tpu_torch)
against the JAX package's, on the CPU.

Weights cross from JAX with ``clip_params_from_jax`` (the tower) and
``params_from_jax`` (the UNet), set from a numpy seed; inputs are numpy
arrays from a seed. Tolerances:

- the tower in float32: embeddings to 1e-5 relative L2 (only the sum orders
  of the products and the LayerNorm statistics differ);
- the tower in bfloat16 against JAX's float32 tower: no further (relative
  L2) than JAX's own bfloat16 tower is, plus 25% (the products and the
  attention round at other points: Flax rounds its softmax to bf16 where
  ``torch.softmax`` keeps float32 inside);
- ``quick_gelu`` to 1e-6 relative (float32 elementwise);
- checkpoints written from the port's tower in the OpenAI, open_clip
  (wrapped, ``module.``-prefixed, half precision) and TorchScript forms load
  in JAX's ``load_torch_clip_weights`` and in the port's loader, which give
  embeddings equal to 1e-5 relative L2; the port's load is exact;
- the extractor (uint8 ImageNet normalization, the bilinear resize to the
  tower's side) to 1e-5 relative L2 against JAX's extractor;
- the CLIP-fused UNet at 64² in float32, with and without features, dense
  and s2d, to rtol 1e-3 / atol 1e-4 against JAX (``tests/test_models.py``'s
  tolerance);
- one ``use_clip`` train step with dropout rates 0: the loss to 1e-5
  relative and every parameter after it to 1e-5 relative L2
  (``tests/test_torch_train.py``'s tolerances), and the eval step's loss to
  1e-5 relative.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_clip import TestHFOracle as _HFOracle
from unet_implementations_tpu.models import clip as jax_clip
from unet_implementations_tpu.models.convert import params_to_torch_unet_state_dict
from unet_implementations_tpu.models.unet import UNet as JaxUNet
from unet_implementations_tpu.training import steps as jax_steps
from unet_implementations_tpu.training import train_state as jax_ts
from unet_implementations_tpu_torch.data.synthetic import as_uint8, synthetic_batch
from unet_implementations_tpu_torch.models import clip, convert
from unet_implementations_tpu_torch.models.unet import S2D_LAYOUT, UNet, unet_6stage
from unet_implementations_tpu_torch.training import checkpoint, steps, train_state

# tests/test_clip.py's tiny tower.
TINY = clip.CLIPVisionConfig(image_size=32, patch_size=16, width=64, layers=2, heads=2,
                             output_dim=16)
JAX_TINY = jax_clip.CLIPVisionConfig(image_size=32, patch_size=16, width=64, layers=2,
                                     heads=2, output_dim=16)
# Six stages at narrow widths (tests/test_torch_model.py's NARROW6) with the
# fusion at a narrow clip_dim.
NARROW6 = dict(features_per_stage=(8, 32, 16, 16, 16, 16))
CLIP_DIM = 24
# The bottleneck fusion's keys, the reference's: its 1x1 conv, then its norm.
FUSION_KEYS = [f"clip_fusion_conv.{i}.{p}" for i in (0, 1) for p in ("weight", "bias")]
LAYOUTS = {"dense": {"s2d_level0": False, "s2d_low_channel_decoders": False}, "s2d": S2D_LAYOUT}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _seeded(tree, rng, path=()):
    """Values for a JAX params tree from numpy: kernels scaled by their fan
    in, non-trivial biases and norm affines (JAX's zero biases and unit
    scales would leave those mappings untested)."""
    out = {}
    for name, node in tree.items():
        if isinstance(node, dict):
            out[name] = _seeded(node, rng, path + (name,))
            continue
        shape = node.shape
        if name == "scale":
            value = 1.0 + 0.1 * rng.normal(size=shape)
        elif name == "bias":
            value = 0.05 * rng.normal(size=shape)
        elif len(shape) >= 2:
            fan_in = shape[0] if path[-1:] in (("query",), ("key",), ("value",)) \
                else math.prod(shape[:-1])
            value = rng.normal(size=shape) / math.sqrt(fan_in)
        else:
            value = 0.02 * rng.normal(size=shape)
        out[name] = value.astype(np.float32)
    return out


def _towers(seed, dtype=torch.float32):
    """The JAX tiny tower's seeded params and the port's tower carrying them."""
    jtower = jax_clip.CLIPVisionTransformer(JAX_TINY, dtype=jnp.float32)
    shapes = jax.eval_shape(jtower.init, jax.random.key(0), jnp.zeros((1, 32, 32, 3)))["params"]
    params = _seeded(shapes, np.random.default_rng(seed))
    tower = clip.CLIPVisionTransformer(TINY, dtype=dtype)
    tower.load_state_dict(convert.clip_params_from_jax(params), strict=True)
    return params, tower


def _jax_embed(params, x, dtype=jnp.float32):
    tower = jax_clip.CLIPVisionTransformer(JAX_TINY, dtype=dtype)
    with jax.default_matmul_precision("highest"):
        return np.asarray(tower.apply({"params": params}, jnp.asarray(x)))


def _images(seed, n=4, side=32):
    return np.random.default_rng(seed).normal(size=(n, side, side, 3)).astype(np.float32)


class TestTower:
    def test_float32_matches_jax(self):
        params, tower = _towers(1)
        x = _images(2)
        with torch.no_grad():
            got = tower(torch.from_numpy(x))
        assert got.dtype == torch.float32 and tuple(got.shape) == (4, 16)
        assert _rel(got.numpy(), _jax_embed(params, x)) <= 1e-5

    def test_bfloat16_against_float32_no_worse_than_jax(self):
        params, tower = _towers(3, torch.bfloat16)
        x = _images(4, n=8)
        want = _jax_embed(params, x)
        with torch.no_grad():
            got = tower(torch.from_numpy(x))
        assert got.dtype == torch.float32
        ours, ref = _rel(got.numpy(), want), _rel(_jax_embed(params, x, jnp.bfloat16), want)
        assert 0 < ours <= ref * 1.25, (ours, ref)

    def test_quick_gelu(self):
        x = np.linspace(-6, 6, 101).astype(np.float32)
        np.testing.assert_allclose(clip.quick_gelu(torch.from_numpy(x)).numpy(),
                                   np.asarray(jax_clip.quick_gelu(jnp.asarray(x))), rtol=1e-6,
                                   atol=1e-7)

    def test_keys_are_the_openai_visual_tower(self):
        keys = list(clip.CLIPVisionTransformer(TINY).state_dict())
        assert keys[:5] == ["class_embedding", "positional_embedding", "proj", "conv1.weight",
                            "ln_pre.weight"]
        block = sorted(k[len("transformer.resblocks.0."):] for k in keys
                       if k.startswith("transformer.resblocks.0."))
        assert block == sorted([
            "attn.in_proj_weight", "attn.in_proj_bias", "attn.out_proj.weight",
            "attn.out_proj.bias", "ln_1.weight", "ln_1.bias", "mlp.c_fc.weight",
            "mlp.c_fc.bias", "mlp.c_proj.weight", "mlp.c_proj.bias", "ln_2.weight",
            "ln_2.bias"])
        assert {k for k in keys if not k.startswith("transformer.")} == {
            "class_embedding", "positional_embedding", "proj", "conv1.weight", "ln_pre.weight",
            "ln_pre.bias", "ln_post.weight", "ln_post.bias"}

    def test_configs_and_seeded_init(self):
        assert {k: (c.patch_size, c.width, c.layers, c.heads, c.output_dim, c.grid)
                for k, c in clip.CLIP_CONFIGS.items()} == \
            {k: (c.patch_size, c.width, c.layers, c.heads, c.output_dim, c.grid)
             for k, c in jax_clip.CLIP_CONFIGS.items()}
        a, b = (clip.CLIPVisionTransformer(TINY, generator=torch.Generator().manual_seed(5))
                for _ in range(2))
        assert all(torch.equal(v, b.state_dict()[k]) for k, v in a.state_dict().items())
        assert all(v.dtype == torch.float32 for v in a.state_dict().values())


class TestCheckpoints:
    @pytest.mark.parametrize("container", ["plain", "open_clip_fp16", "torchscript"])
    def test_forms_load_in_both_packages(self, tmp_path, container):
        params, tower = _towers(6)
        if container == "open_clip_fp16":
            # fp16-representable values, so the half-precision file is exact.
            tower.load_state_dict({k: v.half().float() for k, v in tower.state_dict().items()})
        sd = {f"visual.{k}": v.clone() for k, v in tower.state_dict().items()}
        # A full OpenAI checkpoint also holds the text tower, under the same
        # "transformer." names without the prefix: the loader drops it.
        sd["transformer.resblocks.0.ln_1.weight"] = torch.ones(3)
        sd["token_embedding.weight"] = torch.ones(2, 3)
        path = tmp_path / "clip.pt"
        _HFOracle._save_container(torch, sd, path, container)

        loaded = clip.load_torch_clip_weights(path, clip.CLIPVisionTransformer(TINY))
        for k, v in tower.state_dict().items():
            assert torch.equal(loaded.state_dict()[k], v), k
        jtower = jax_clip.CLIPVisionTransformer(JAX_TINY)
        abstract = jtower.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))["params"]
        jparams = jax_clip.load_torch_clip_weights(path, abstract)
        x = _images(7)
        with torch.no_grad():
            got = loaded(torch.from_numpy(x)).numpy()
        assert _rel(got, _jax_embed(jparams, x)) <= 1e-5

    def test_mismatched_checkpoint_raises(self, tmp_path):
        sd = clip.CLIPVisionTransformer(TINY).state_dict()
        del sd["proj"]
        torch.save(sd, tmp_path / "bad.pt")
        with pytest.raises(RuntimeError, match="proj"):
            clip.load_torch_clip_weights(tmp_path / "bad.pt", clip.CLIPVisionTransformer(TINY))
        with pytest.raises(FileNotFoundError):
            clip.ClipFeatureExtractor("ViT-B/16", tmp_path / "absent.pt", device="cpu")


class TestExtractor:
    @pytest.fixture
    def pair(self, monkeypatch):
        """JAX's extractor and the port's on the tiny tower, in float32, with
        JAX's init carried across."""
        monkeypatch.setitem(jax_clip.CLIP_CONFIGS, "tiny", JAX_TINY)
        monkeypatch.setitem(clip.CLIP_CONFIGS, "tiny", TINY)
        jex = jax_clip.ClipFeatureExtractor("tiny", dtype=jnp.float32)
        ex = clip.ClipFeatureExtractor("tiny", dtype=torch.float32, device="cpu")
        ex.model.load_state_dict(convert.clip_params_from_jax(jax.device_get(jex.params)))
        return jex, ex

    @pytest.mark.parametrize("side,kind", [(32, "uint8"), (48, "uint8"), (40, "float")])
    def test_preprocessing_matches_jax(self, pair, side, kind):
        jex, ex = pair
        rng = np.random.default_rng(side)
        if kind == "uint8":
            x = rng.integers(0, 256, (3, side, side, 3)).astype(np.uint8)
        else:
            x = rng.normal(size=(3, side, side, 3)).astype(np.float32)
        with jax.default_matmul_precision("highest"):
            want = np.asarray(jex(jnp.asarray(x)))
        got = ex(x)
        assert got.dtype == torch.float32 and not got.requires_grad
        assert _rel(got.numpy(), want) <= 1e-5

    def test_frozen(self, pair):
        _, ex = pair
        assert not ex.model.training
        assert not any(p.requires_grad for p in ex.model.parameters())

    def test_zeros(self):
        ex = clip.ClipFeatureExtractor("ViT-B/16", zeros=True, device="cpu")
        assert ex.model is None
        out = ex(np.ones((3, 224, 224, 3), np.uint8))
        assert out.dtype == torch.float32 and tuple(out.shape) == (3, 512)
        assert not out.any()

    def test_no_card_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            clip.ClipFeatureExtractor("ViT-B/16", zeros=True)


def _fusion_pair(layout, seed, size=64, config=NARROW6):
    jmodel = JaxUNet(**config, clip_fusion=True, clip_dim=CLIP_DIM, **LAYOUTS[layout])
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    cf = rng.normal(size=(2, CLIP_DIM)).astype(np.float32)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.asarray(x),
                            jnp.asarray(cf))["params"]
    params = _seeded(shapes, rng)
    model = UNet(**config, clip_fusion=True, clip_dim=CLIP_DIM, **LAYOUTS[layout]).eval()
    model.load_state_dict(convert.params_from_jax(params, model), strict=True)
    return jmodel, params, model, x, cf


class TestFusionModel:
    @pytest.mark.parametrize("features", [True, False], ids=["features", "no-features"])
    @pytest.mark.parametrize("layout", ["dense", "s2d"])
    def test_matches_jax(self, layout, features):
        jmodel, params, model, x, cf = _fusion_pair(layout, seed=21)
        jcf = jnp.asarray(cf) if features else None
        want = np.asarray(jax.jit(lambda p, v, c: jmodel.apply({"params": p}, v, c))(
            params, jnp.asarray(x), jcf))
        with torch.no_grad():
            got = model(torch.from_numpy(x), torch.from_numpy(cf) if features else None)
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-4)
        # The features change the output, and a model without the fusion
        # ignores them (as JAX's does).
        with torch.no_grad():
            unfused = model(torch.from_numpy(x))
        assert torch.equal(got, unfused) != features

    def test_channel_order(self):
        """The UNet features come first in the concat, then the embedding:
        zeroing the conv's input columns of the embedding removes its effect."""
        _, _, model, x, cf = _fusion_pair("dense", seed=22)
        with torch.no_grad():
            model.clip_fusion_conv[0].weight[:, 16:] = 0
            a = model(torch.from_numpy(x), torch.from_numpy(cf))
            b = model(torch.from_numpy(x), torch.from_numpy(-cf))
        assert torch.equal(a, b)

    def test_keys_and_init(self):
        plain = unet_6stage(device="cpu", generator=torch.Generator().manual_seed(3))
        fused = unet_6stage(device="cpu", generator=torch.Generator().manual_seed(3),
                            clip_fusion=True)
        keys = list(fused.state_dict())
        assert keys[:-4] == list(plain.state_dict()) and keys[-4:] == FUSION_KEYS
        assert tuple(fused.clip_fusion_conv[0].weight.shape) == (512, 1024, 1, 1)
        # The fusion is drawn last: the rest of the init is the plain model's.
        assert all(torch.equal(v, fused.state_dict()[k]) for k, v in plain.state_dict().items())

    def test_jax_export_loads_strictly(self, tmp_path):
        """JAX's ``params_to_torch_unet_state_dict`` of the full-width fusion
        model loads strictly; a ``.pth`` without the fusion keys loads with
        the fusion at its init; one missing only some of them raises."""
        jmodel = JaxUNet(clip_fusion=True)
        shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, 64, 64, 3)),
                                jnp.zeros((1, 512)))["params"]
        params = _seeded(shapes, np.random.default_rng(23))
        sd = {k: torch.from_numpy(v) for k, v in
              params_to_torch_unet_state_dict(params, jmodel).items()}
        model = unet_6stage(device="cpu", clip_fusion=True)
        model.load_state_dict(sd, strict=True)
        path = tmp_path / "clip_unet.pth"
        torch.save({"epoch": 3, "model_state_dict": sd, "best_dice": 0.5}, path)
        loaded = convert.load_reference_checkpoint(path, device="cpu", dtype=torch.float32,
                                                   arch="clip_unet")
        assert all(torch.equal(v, sd[k]) for k, v in loaded.state_dict().items())

        init = unet_6stage(device="cpu", clip_fusion=True).state_dict()
        no_fusion = {k: v for k, v in sd.items() if not k.startswith("clip_fusion_conv.")}
        torch.save(no_fusion, path)
        loaded = convert.load_reference_checkpoint(path, device="cpu", arch="clip_unet",
                                                   **S2D_LAYOUT)
        for k, v in loaded.state_dict().items():
            assert torch.equal(v, init[k] if k in FUSION_KEYS else sd[k]), k
        torch.save({k: v for k, v in sd.items() if k != "clip_fusion_conv.1.bias"}, path)
        with pytest.raises(RuntimeError, match="clip_fusion_conv.1.bias"):
            convert.load_reference_checkpoint(path, device="cpu", arch="clip_unet")
        # Other archs stay strict about the fusion keys.
        torch.save(sd, path)
        with pytest.raises(RuntimeError, match="clip_fusion_conv"):
            convert.load_reference_checkpoint(path, device="cpu", arch="our_unet")

    def test_restore_params_without_fusion_keys(self, tmp_path):
        """``restore_params`` (the recipes' evaluate) follows the same rule
        as ``load_reference_checkpoint``: a checkpoint without the fusion
        keys loads with the fusion at its init, a partial fusion raises."""
        config = dict(features_per_stage=(8, 16, 32), strides=(1, 2, 2),
                      encoder_dropout_rates=(0.0,) * 3, decoder_dropout_rates=(0.0,) * 2,
                      clip_fusion=True, clip_dim=CLIP_DIM)
        trained = UNet(**config, generator=torch.Generator().manual_seed(5))
        sd = {k: v for k, v in trained.state_dict().items() if k not in FUSION_KEYS}
        torch.save({"model_state_dict": sd}, tmp_path / "no_fusion.pth")
        init = UNet(**config, generator=torch.Generator().manual_seed(6)).state_dict()
        fresh = checkpoint.restore_params(tmp_path / "no_fusion.pth",
                                          UNet(**config, generator=torch.Generator().manual_seed(6)))
        for k, v in fresh.state_dict().items():
            assert torch.equal(v, init[k] if k in FUSION_KEYS else sd[k]), k
        torch.save(dict(sd, **{FUSION_KEYS[0]: trained.state_dict()[FUSION_KEYS[0]]}),
                   tmp_path / "partial.pth")
        with pytest.raises(RuntimeError, match="clip_fusion_conv.1.weight"):
            checkpoint.restore_params(tmp_path / "partial.pth", UNet(**config))
        plain = {k: v for k, v in config.items() if k not in ("clip_fusion", "clip_dim")}
        with pytest.raises(RuntimeError, match="clip_fusion_conv.0.weight"):
            checkpoint.restore_params(tmp_path / "partial.pth", UNet(**plain))


class TestClipSteps:
    # tests/test_torch_train.py's TINY3: at 32² the bottleneck is 8x8.
    CONFIG = dict(features_per_stage=(8, 16, 32), strides=(1, 2, 2),
                  encoder_dropout_rates=(0.0,) * 3, decoder_dropout_rates=(0.0,) * 2)

    def _pair(self, layout, seed):
        jmodel, params, model, _, _ = _fusion_pair(layout, seed, size=32, config=self.CONFIG)
        tx = jax_ts.sgd_nesterov()
        params = jax.tree.map(jnp.asarray, params)
        state = jax_ts.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                  opt_state=tx.init(params), tx=tx, apply_fn=jmodel.apply)
        batch = as_uint8(synthetic_batch(seed, 2, 32))
        batch["clip_features"] = np.random.default_rng(seed).normal(
            size=(2, CLIP_DIM)).astype(np.float32)
        return state, model.train(), batch

    @pytest.mark.parametrize("layout", ["dense", "s2d"])
    def test_train_step_matches_jax(self, layout):
        state, model, batch = self._pair(layout, 31)
        state, jloss = jax_steps.make_segmentation_train_step(use_clip=True, donate=False)(
            state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(0))
        step = steps.make_segmentation_train_step(
            model, train_state.sgd_nesterov(model.parameters()), use_clip=True)
        loss = step(batch, torch.Generator().manual_seed(0))
        assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
        want = convert.params_from_jax(jax.device_get(state.params), model)
        for key, value in model.state_dict().items():
            assert _rel(value.numpy(), want[key].numpy()) <= 1e-5, key
        # The fusion trained.
        assert not torch.equal(model.clip_fusion_conv[0].weight,
                               self._pair(layout, 31)[1].clip_fusion_conv[0].weight)

    def test_eval_step_matches_jax(self):
        state, model, batch = self._pair("s2d", 32)
        want = jax_steps.make_segmentation_eval_step(use_clip=True)(
            state, {k: jnp.asarray(v) for k, v in batch.items()})
        got = steps.make_segmentation_eval_step(model, use_clip=True)(batch)
        assert abs(float(got["loss"]) - float(want["loss"])) <= 1e-5 * abs(float(want["loss"]))
        plain = steps.make_segmentation_eval_step(model)(batch)
        assert float(plain["loss"]) != float(got["loss"])
