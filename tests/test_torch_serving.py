"""The port's serving artifact (``serving/export.py``) and checkpoint
converters against the JAX package's, on the CPU.

- The port's artifact of a small UNet (64², float32), exported on the CPU,
  gives the logits of JAX's artifact (``save_exported(platforms=("cpu",))``)
  of the same weights (``params_from_jax``) to rtol 1e-3 / atol 1e-4, in the
  dense and the space-to-depth layout; and its replay is bit for bit the
  port's eager forward.
- Mirrors of ``tests/test_serving.py``: ``predict`` pads and chunks, the
  CLIP variant takes two inputs, a fresh process loads and replays the
  artifact without ``models/``, ``predict_segmentation`` detects an artifact
  directory, ``cli export`` from a checkpoint.
- The exported graph of the 6-stage models holds one kernel operator node
  per launch (K1/K2a/K2b/K3: 22/5/0/0 dense, 16/3/2/3 s2d, 23/5/0/0 with
  the CLIP fusion, 22/5/0/0 for the autoencoder) and none of the plain
  versions' ops.
- Refusals: ``--spatial`` with an artifact, a non-512 artifact in
  ``predict``, an artifact loaded on another device.
- ``cli convert`` then ``cli export_torch`` of a reference ``.pth`` returns
  its tensors, and the converted checkpoint holds what JAX's
  ``convert_torch_checkpoint`` restores, carried by ``params_from_jax``.
"""

import collections
import json
import os
import subprocess
import sys
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_implementations_tpu.models import convert as jax_convert
from unet_implementations_tpu.models.unet import UNet as JaxUNet
from unet_implementations_tpu.models.unet import autoencoder_6stage as jax_autoencoder_6stage
from unet_implementations_tpu.models.unet import unet_6stage as jax_unet_6stage
from unet_implementations_tpu.serving import load_exported as jax_load_exported
from unet_implementations_tpu.serving import save_exported as jax_save_exported
from unet_implementations_tpu.training.checkpoint import restore_params as jax_restore_params
from unet_implementations_tpu_torch import cli
from unet_implementations_tpu_torch.models import convert
from unet_implementations_tpu_torch.models.unet import S2D_LAYOUT, UNet, autoencoder_6stage, unet_6stage
from unet_implementations_tpu_torch.recipes.common import predict_segmentation
from unet_implementations_tpu_torch.serving import export_forward, load_exported, save_exported
from unet_implementations_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(features_per_stage=(8, 16, 16), strides=(1, 2, 2),
             encoder_dropout_rates=(0.0, 0.0, 0.0), decoder_dropout_rates=(0.0, 0.0))
LAYOUTS = {"dense": {}, "s2d": S2D_LAYOUT}
BF16 = torch.bfloat16
KERNEL_OPS = ("in_lrelu_fwd", "upsample2x", "upsample2x_s2d", "s2d_tail")
# What the plain versions of K1, K2 and K3 compute with, which a graph of
# the models' forward holds only inside those versions.
PLAIN_OPS = ("rsqrt", "sum", "mean", "var", "clamp", "where", "mul")


def _seeded_params(tree, rng):
    """Values for the JAX params tree from numpy: Kaiming fan_out kernels,
    non-trivial biases and norm affines."""
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


def _jax_and_port(config, size, seed, clip_dim=None, **layout):
    """A JAX UNet and its params, and the port's UNet with the same weights."""
    clip = {} if clip_dim is None else {"clip_fusion": True, "clip_dim": clip_dim}
    jmodel = JaxUNet(**config, **clip, dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    args = (jnp.zeros((1, size, size, 3)),) + (() if clip_dim is None
                                                else (jnp.zeros((1, clip_dim)),))
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), *args)["params"]
    params = _seeded_params(shapes, rng)
    model = UNet(**config, **clip, **layout).eval()
    model.load_state_dict(convert.params_from_jax(params, model), strict=True)
    return jmodel, params, model


def _eager(model, *args):
    with torch.no_grad():
        return model(*(torch.from_numpy(a) for a in args))


def _op_counts(program) -> dict:
    counts = collections.Counter(str(n.target).split(".")[1] for n in program.graph.nodes
                                 if n.op == "call_function"
                                 and str(n.target).startswith("unet_torch."))
    return {name: counts[name] for name in KERNEL_OPS}


class TestExportRoundtrip:
    @pytest.mark.parametrize("layout", LAYOUTS)
    def test_matches_jax_artifact(self, layout, tmp_path):
        jmodel, params, model = _jax_and_port(SMALL, 64, seed=3, **LAYOUTS[layout])
        x = np.random.default_rng(4).normal(size=(2, 64, 64, 3)).astype(np.float32)
        jart = jax_save_exported(tmp_path / "jax", jmodel, params, recipe="our_unet",
                                 batch_size=2, img_size=64, input_dtype=jnp.float32,
                                 platforms=("cpu",))
        want = jax_load_exported(jart).predict(jnp.asarray(x))
        art = save_exported(tmp_path / "port", model, batch_size=2, img_size=64,
                            input_dtype=torch.float32)
        served = load_exported(art, device="cpu")
        got = served.predict(x)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
        # The replay is the eager forward, bit for bit.
        assert torch.equal(torch.from_numpy(got), _eager(model, x))
        meta = json.loads((art / "export_meta.json").read_text())
        jmeta = json.loads((jart / "export_meta.json").read_text())
        assert set(meta) == set(jmeta) - {"jax_version", "platforms"} | {"torch_version",
                                                                           "device"}
        assert meta["device"] == "cpu" and meta["input_dtype"] == "float32"
        assert meta["output_shape"] == jmeta["output_shape"] == [2, 64, 64, 3]

    def test_predict_pads_and_chunks_arbitrary_batches(self, tmp_path):
        _, _, model = _jax_and_port(SMALL, 32, seed=5)
        served = load_exported(save_exported(tmp_path / "art", model, batch_size=2, img_size=32,
                                             input_dtype=torch.float32), device="cpu")
        # 5 images through a batch-2 program: 2 full chunks and a padded tail.
        x = np.random.default_rng(2).normal(size=(5, 32, 32, 3)).astype(np.float32)
        ref = _eager(model, x).numpy()
        out = served.predict(x)
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
        with pytest.raises(ValueError, match="empty batch"):
            served.predict(x[:0])

    def test_clip_variant_two_inputs(self, tmp_path):
        jmodel, params, model = _jax_and_port(SMALL, 32, seed=6, clip_dim=16)
        art = save_exported(tmp_path / "art", model, recipe="clip_unet", batch_size=2,
                            img_size=32, clip_dim=16, input_dtype=torch.float32)
        served = load_exported(art, device="cpu")
        assert served.meta["clip_dim"] == 16
        rng = np.random.default_rng(7)
        xs = rng.normal(size=(3, 32, 32, 3)).astype(np.float32)
        cfs = rng.normal(size=(3, 16)).astype(np.float32)
        out = served.predict(xs, cfs)
        np.testing.assert_allclose(out, _eager(model, xs, cfs).numpy(), rtol=1e-4, atol=1e-4)
        want = jmodel.apply({"params": params}, jnp.asarray(xs), jnp.asarray(cfs),
                            deterministic=True)
        np.testing.assert_allclose(out, np.asarray(want), rtol=1e-3, atol=1e-4)

    def test_loader_needs_no_model_code(self, tmp_path):
        """A fresh process loads the artifact and replays it bit for bit with
        the kernel modules alone: ``models/`` is never imported."""
        _, _, model = _jax_and_port(SMALL, 32, seed=8, **S2D_LAYOUT)
        art = save_exported(tmp_path / "art", model, batch_size=2, img_size=32,
                            input_dtype=torch.float32)
        x = np.random.default_rng(9).normal(size=(2, 32, 32, 3)).astype(np.float32)
        np.save(tmp_path / "x.npy", x)
        np.save(tmp_path / "want.npy", _eager(model, x).numpy())
        code = r"""
import json, sys
import numpy as np
from unet_implementations_tpu_torch.serving import load_exported
served = load_exported(sys.argv[1], device="cpu")
got = served.predict(np.load(sys.argv[2]))
print(json.dumps({"equal": bool(np.array_equal(got, np.load(sys.argv[3]))),
                  "models": sorted(m for m in sys.modules
                                   if m.startswith("unet_implementations_tpu_torch.models"))}))
"""
        env = dict(os.environ, PYTHONPATH=str(REPO))
        out = subprocess.run([sys.executable, "-c", code, str(art), str(tmp_path / "x.npy"),
                              str(tmp_path / "want.npy")], capture_output=True, text=True,
                             env=env, cwd=str(tmp_path), timeout=300)
        assert out.returncode == 0, out.stderr
        result = json.loads(out.stdout.strip().splitlines()[-1])
        assert result == {"equal": True, "models": []}


class TestExportedGraph:
    @pytest.mark.parametrize("name,build,clip,want", [
        ("dense", lambda: unet_6stage(BF16, "cpu"), False, (22, 5, 0, 0)),
        ("s2d", lambda: unet_6stage(BF16, "cpu", **S2D_LAYOUT), False, (16, 3, 2, 3)),
        ("clip", lambda: unet_6stage(BF16, "cpu", clip_fusion=True), True, (23, 5, 0, 0)),
        ("autoencoder", lambda: autoencoder_6stage(BF16, "cpu"), False, (22, 5, 0, 0)),
    ], ids=["dense", "s2d", "clip", "autoencoder"])
    def test_one_operator_node_per_launch(self, name, build, clip, want):
        """The 6-stage models at 64², bf16: each kernel is its operator's
        node, as many as the card counts launches per forward, and no op of
        the plain versions is in the graph."""
        model = build()
        program = export_forward(model, batch_size=1, img_size=64,
                                 clip_dim=model.clip_dim if clip else None)
        assert tuple(_op_counts(program).values()) == want
        plain = [str(n.target) for n in program.graph.nodes if n.op == "call_function"
                 and str(n.target).split(".")[:2] in [["aten", op] for op in PLAIN_OPS]]
        assert plain == []
        assert model.training  # traced in eval mode, then restored


class TestPredictFromArtifact:
    def test_predict_auto_detects_exported_artifact(self, tmp_path):
        """``predict --model_path <artifact>`` replays the exported program."""
        model = unet_6stage(dtype=torch.float32, device="cpu").eval()
        art = save_exported(tmp_path / "art", model, batch_size=2, img_size=512,
                            input_dtype=torch.float32)
        imgs = tmp_path / "imgs"
        imgs.mkdir()
        rng = np.random.default_rng(0)
        cv2.imwrite(str(imgs / "a.jpg"), (rng.random((40, 30, 3)) * 255).astype(np.uint8))
        out = tmp_path / "preds"
        n = predict_segmentation(art, imgs, out, batch_size=2, device="cpu", verbose=False)
        assert n == 1
        mask = cv2.imread(str(out / "a_mask.png"), cv2.IMREAD_GRAYSCALE)
        assert mask.shape == (40, 30)
        assert set(np.unique(mask)) <= {0, 1, 2}

    def test_refusals(self, tmp_path):
        _, _, model = _jax_and_port(SMALL, 32, seed=10)
        art = save_exported(tmp_path / "art", model, batch_size=1, img_size=32,
                            input_dtype=torch.float32)
        with pytest.raises(ValueError, match="--spatial applies to training checkpoints"):
            predict_segmentation(art, tmp_path, tmp_path / "p", device="cpu", spatial=2)
        with pytest.raises(ValueError, match="exported artifact is 32px"):
            predict_segmentation(art, tmp_path, tmp_path / "p", device="cpu")
        with pytest.raises(ValueError, match="was exported on cpu"):
            load_exported(art, device="meta")


class TestExportCLI:
    def test_cli_export_from_checkpoint(self, tmp_path):
        model = unet_6stage(dtype=torch.float32, device="cpu",
                            generator=torch.Generator().manual_seed(3))
        save_checkpoint(tmp_path / "ckpt", model, None, epoch=1, best_metric=0.0)
        meta = cli.main(["export", "--model_path", str(tmp_path / "ckpt"), "--output_dir",
                         str(tmp_path / "art"), "--arch", "our_unet", "--batch_size", "1",
                         "--img_size", "64", "--device", "cpu", "--f32"])
        served = load_exported(tmp_path / "art", device="cpu")
        assert served.meta == meta and meta["recipe"] == "our_unet"
        x = np.random.default_rng(6).normal(size=(1, 64, 64, 3)).astype(np.float32)
        assert torch.equal(torch.from_numpy(served.predict(x)), _eager(model.eval(), x))


class TestConvert:
    @pytest.mark.parametrize("arch,jax_build", [("our_unet", jax_unet_6stage),
                                                ("ae_recon", jax_autoencoder_6stage)])
    def test_convert_round_trip_matches_jax(self, arch, jax_build, tmp_path):
        """A reference ``.pth`` -> ``cli convert`` -> ``cli export_torch``
        gives its tensors back (and its epoch and best_dice); the converted
        checkpoint's weights are what JAX's ``convert_torch_checkpoint``
        restores, carried by ``params_from_jax``."""
        build = unet_6stage if arch == "our_unet" else autoencoder_6stage
        model = build(device="cpu", generator=torch.Generator().manual_seed(11))
        with torch.no_grad():  # non-trivial norm affines and biases
            for p in model.parameters():
                p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(12)))
        sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
        pth = tmp_path / "ref.pth"
        torch.save({"epoch": 7, "model_state_dict": sd, "best_dice": 0.625}, str(pth))

        cli.main(["convert", "--torch_checkpoint", str(pth), "--output",
                  str(tmp_path / "ckpt"), "--arch", arch])
        cli.main(["export_torch", "--checkpoint", str(tmp_path / "ckpt"), "--output",
                  str(tmp_path / "back.pth"), "--arch", arch])
        back = torch.load(str(tmp_path / "back.pth"), weights_only=True)
        assert back["epoch"] == 7 and back["best_dice"] == 0.625
        assert back["config"]["arch"] == arch
        assert set(back["model_state_dict"]) == set(sd)
        for k, v in sd.items():
            assert torch.equal(back["model_state_dict"][k], v), k

        jax_convert.convert_torch_checkpoint(pth, tmp_path / "orbax", arch)
        jmodel = jax_build()
        abstract = jax.eval_shape(lambda: jmodel.init(jax.random.key(0),
                                                      jnp.zeros((1, 64, 64, 3))))["params"]
        params = jax_restore_params(tmp_path / "orbax", abstract)
        via_jax = convert.params_from_jax(jax.tree.map(np.asarray, params), model)
        ours = load_checkpoint(tmp_path / "ckpt")["model_state_dict"]
        assert set(via_jax) == set(ours)
        for k, v in via_jax.items():
            assert torch.equal(ours[k], v), k
