"""The port's AE_pretrained recipes and CLI (unet_implementations_tpu_torch)
against the JAX package's.

- One chain through the CLI on the CPU, float32, on 2+2+2 images of 64²
  originals (the models are the full-width ``autoencoder_6stage`` and
  ``unet_6stage`` at 512²): ``ae_recon train`` (1 epoch, b2) ->
  ``ae_recon evaluate`` -> ``ae_transfer train --pretrained_encoder
  <ae>/best_model`` -> ``ae_transfer evaluate``. The artifacts have the keys
  and headers of JAX's (``training_config.json`` those of JAX's ``train()``,
  the CSV headers, ``reconstruction_metrics.json`` and
  ``evaluation_results.json`` those in ``demo/four_recipes/``); the AE's
  ``best_model/model.pth`` loads into JAX's ``autoencoder_6stage`` and gives
  the port's float32 reconstruction to 1e-4 relative at 64²; the transfer's
  encoder equals the AE's bit for bit and its decoders moved.
- Every JAX flag of ``ae_recon`` and ``ae_transfer`` exists with JAX's
  defaults; the flags that are not ported raise, naming their ROADMAP item.
"""

import csv
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_implementations_tpu.cli import build_parser as jax_build_parser
from unet_implementations_tpu.models import convert as jax_convert
from unet_implementations_tpu.models.unet import autoencoder_6stage as jax_autoencoder_6stage
from unet_implementations_tpu.recipes import ae_recon as jax_ae_recon
from unet_implementations_tpu.recipes import ae_transfer as jax_ae_transfer
from unet_implementations_tpu_torch import cli
from unet_implementations_tpu_torch.models.unet import UNet, autoencoder_6stage
from unet_implementations_tpu_torch.recipes import ae_recon, ae_transfer, common
from unet_implementations_tpu_torch.training import checkpoint
from unet_implementations_tpu_torch.training.loop import AE_CSV_HEADER, SEG_CSV_HEADER

from test_torch_recipe import SPLITS, count_calls, reaches_config, write_split

DEMO = Path(__file__).resolve().parents[1] / "demo" / "four_recipes"


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """ae_recon train -> evaluate -> ae_transfer train -> evaluate through
    the CLI (float32, CPU)."""
    root = tmp_path_factory.mktemp("ae_chain")
    data, ae, tr = root / "data", root / "ae", root / "transfer"
    for split, seed in zip(SPLITS, (12, 13, 14)):
        write_split(data, split, [(64, 64), (64, 48)], seed)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("UNET_TPU_DECODE_CACHE", "")
        flags = ["--data_dir", str(data), "--device", "cpu", "--f32", "--batch_size", "2",
                 "--num_workers", "2", "--decode_cache", str(root / "cache")]
        out = {"ae_train": cli.main(["ae_recon", "train", "--output_dir", str(ae),
                                     "--epochs", "1", *flags]),
               "ae_eval": cli.main(["ae_recon", "evaluate", "--model_path",
                                    str(ae / "best_model"), "--output_dir", str(ae / "eval"),
                                    *flags]),
               "tr_train": cli.main(["ae_transfer", "train", "--output_dir", str(tr),
                                     "--epochs", "1", "--pretrained_encoder",
                                     str(ae / "best_model"), *flags]),
               "tr_eval": cli.main(["ae_transfer", "evaluate", "--model_path",
                                    str(tr / "best_model"), "--output_dir", str(tr / "eval"),
                                    *flags])}
    return {"root": root, "ae": ae, "tr": tr, **out}


def _captured_config(monkeypatch, module, tmp_path, **kwargs):
    """The keys JAX's ``train()`` writes to training_config.json."""
    captured = {}

    class Written(Exception):
        pass

    def capture(output_dir, config):
        captured.update(config)
        raise Written

    monkeypatch.setattr(module, "write_training_config", capture)
    with pytest.raises(Written):
        module.train(tmp_path / "d", tmp_path / "o", use_mesh=False, **kwargs)
    return list(captured)


class TestChain:
    def test_ae_artifacts(self, chain):
        ae = chain["ae"]
        assert chain["ae_train"]["epochs_run"] == 1 and chain["ae_train"]["step"] == 1
        for d in (ae / "checkpoints" / "epoch_1", ae / "best_model"):
            assert (d / "model.pth").is_file() and (d / "meta.json").is_file()
        with open(ae / "training_log.csv") as f:
            rows = list(csv.reader(f))
        assert ",".join(rows[0]) == AE_CSV_HEADER == \
            (DEMO / "ae" / "training_log.csv").read_text().splitlines()[0]
        assert len(rows) == 2 and rows[1][0] == "1" and rows[1][5] == "0.0010000"
        assert np.isfinite([float(v) for v in rows[1][1:5]]).all()
        # The reconstruction loss is the MSE: val_loss == val_mse.
        assert rows[1][2] == rows[1][3]
        meta = json.loads((ae / "best_model" / "meta.json").read_text())
        assert meta["config"] == ae_recon.ARCH_CONFIG == jax_ae_recon.ARCH_CONFIG

    def test_training_config_keys_equal_jax(self, chain, monkeypatch, tmp_path):
        ae = json.loads((chain["ae"] / "training_config.json").read_text())
        assert list(ae) == _captured_config(monkeypatch, jax_ae_recon, tmp_path)
        assert list(ae) == list(json.loads((DEMO / "ae" / "training_config.json").read_text()))
        assert ae["lr"] == 1e-3 and ae["weight_decay"] == 1e-5 and ae["dtype"] == "torch.float32"
        tr = json.loads((chain["tr"] / "training_config.json").read_text())
        assert list(tr) == _captured_config(monkeypatch, jax_ae_transfer, tmp_path,
                                            pretrained_encoder="p")
        assert list(tr) == list(json.loads(
            (DEMO / "transfer" / "training_config.json").read_text()))
        assert tr["pretrained_encoder"] == str(chain["ae"] / "best_model")

    def test_reconstruction_metrics(self, chain):
        written = json.loads((chain["ae"] / "eval" / "reconstruction_metrics.json").read_text())
        assert list(written) == list(json.loads(
            (DEMO / "ae" / "reconstruction_metrics.json").read_text()))
        assert written == chain["ae_eval"] and written["num_images"] == 2
        assert np.isfinite([written[k] for k in ("mse", "psnr", "ssim")]).all()

    def test_ae_best_model_loads_into_jax(self, chain):
        path = chain["ae"] / "best_model" / "model.pth"
        jmodel = jax_autoencoder_6stage(dtype=jnp.float32)
        params = jax_convert.load_torch_checkpoint(path, jmodel)
        x = np.random.default_rng(5).random((1, 64, 64, 3)).astype(np.float32)
        want = np.asarray(jax.jit(lambda p, v: jmodel.apply({"params": p}, v))(
            params, jnp.asarray(x)))
        model = checkpoint.restore_params(path.parent, autoencoder_6stage(device="cpu")).eval()
        with torch.no_grad():
            got = model(torch.from_numpy(x)).numpy()
        assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-4

    def test_transfer_keeps_the_ae_encoder(self, chain):
        ae = checkpoint.load_checkpoint(chain["ae"] / "best_model")["model_state_dict"]
        tr_ckpt = checkpoint.load_checkpoint(chain["tr"] / "best_model")
        tr = tr_ckpt["model_state_dict"]
        assert list(tr) == list(UNet().state_dict())
        encoder = [k for k in tr if k.startswith("encoder_stages.")]
        assert len(encoder) == 6 * 8
        for k in encoder:
            assert torch.equal(tr[k], ae[k]), k
        # The decoders trained from the seeded init: each moved.
        init = ae_transfer.build_model(torch.float32, "cpu").state_dict()
        for k in tr:
            if k.startswith("decoder_stages.") and k.endswith("weight"):
                assert not torch.equal(tr[k], init[k]), k
        # Only the trainable parameters have optimizer state.
        assert len(tr_ckpt["optimizer_state_dict"]["state"]) == len(tr) - len(encoder)
        assert tr_ckpt["config"] == ae_transfer.ARCH_CONFIG == jax_ae_transfer.ARCH_CONFIG

    def test_transfer_artifacts(self, chain):
        tr = chain["tr"]
        assert chain["tr_train"]["epochs_run"] == 1
        with open(tr / "training_log.csv") as f:
            rows = list(csv.reader(f))
        assert ",".join(rows[0]) == SEG_CSV_HEADER == \
            (DEMO / "transfer" / "training_log.csv").read_text().splitlines()[0]
        assert len(rows) == 2 and rows[1][7] == "0.0050000"
        demo = json.loads((DEMO / "transfer" / "evaluation_results.json").read_text())
        written = json.loads((tr / "eval" / "evaluation_results.json").read_text())
        assert list(written) == list(demo) and written == chain["tr_eval"]


def _options(parser, recipe):
    action = next(a for a in parser._actions if a.dest in ("recipe", "command"))
    sub = next(a for a in action.choices[recipe]._actions if a.dest == "cmd").choices
    return {cmd: {s for a in p._actions for s in a.option_strings} for cmd, p in sub.items()}


def test_transfer_online_augment_trains(chain, tmp_path, monkeypatch):
    """``ae_transfer train --online_augment`` on the phase-1 checkpoint: one
    augmentation per training batch, and the grafted encoder stays frozen."""
    calls = count_calls(monkeypatch, common, "augment_and_normalize")
    monkeypatch.setenv("UNET_TPU_DECODE_CACHE", "")
    out = tmp_path / "run"
    result = cli.main(["ae_transfer", "train", "--online_augment", "--output_dir", str(out),
                       "--pretrained_encoder", str(chain["ae"] / "best_model"), "--data_dir",
                       str(chain["root"] / "data"), "--device", "cpu", "--f32",
                       "--batch_size", "2", "--epochs", "1", "--num_workers", "2"])
    assert result["step"] == 1 and len(calls) == 1
    ae = checkpoint.load_checkpoint(chain["ae"] / "best_model")["model_state_dict"]
    tr = checkpoint.load_checkpoint(out / "best_model")["model_state_dict"]
    encoder = [k for k in tr if k.startswith("encoder_stages.")]
    assert encoder and all(torch.equal(tr[k], ae[k]) for k in encoder)


class TestCli:
    @pytest.mark.parametrize("recipe", ["ae_recon", "ae_transfer"])
    def test_every_jax_flag_exists(self, recipe):
        ours, ref = _options(cli.build_parser(), recipe), _options(jax_build_parser(), recipe)
        assert ours.keys() == ref.keys() == {"train", "evaluate"}
        for cmd in ref:
            assert ref[cmd] <= ours[cmd], ref[cmd] - ours[cmd]

    @pytest.mark.parametrize("argv,want", [
        (["ae_recon", "train", "--data_dir", "d", "--output_dir", "o"],
         dict(batch_size=32, lr=1e-3, weight_decay=1e-5, mse_weight=1.0, perceptual_weight=0.0,
              ssim_weight=0.0, epochs=100, patience=15, save_every=10, grad_accum=1,
              device=None)),
        (["ae_recon", "evaluate", "--model_path", "m", "--data_dir", "d"],
         dict(analyze_latent_space=False, output_dir="evaluation_results", batch_size=32)),
        (["ae_transfer", "train", "--data_dir", "d", "--output_dir", "o",
          "--pretrained_encoder", "p", "--no-weighted_ce", "--num_workers", "3"],
         dict(pretrained_encoder="p", lr=5e-3, weight_decay=1e-4, momentum=0.99,
              weighted_ce=False, num_workers=3)),
        (["ae_transfer", "evaluate", "--model_path", "m", "--data_dir", "d", "--device", "cpu"],
         dict(device="cpu", visualize_samples=0)),
    ])
    def test_jax_argv_parses(self, argv, want):
        args = cli.build_parser().parse_args(argv)
        assert {k: getattr(args, k) for k in want} == want
        ref = jax_build_parser().parse_args(argv)
        assert {k: getattr(ref, k) for k in want if k != "visualize_samples"} == \
            {k: v for k, v in want.items() if k != "visualize_samples"}

    def test_pretrained_encoder_required(self, capsys):
        with pytest.raises(SystemExit):
            cli.build_parser().parse_args(["ae_transfer", "train", "--data_dir", "d",
                                           "--output_dir", "o"])
        assert "--pretrained_encoder" in capsys.readouterr().err

    @pytest.mark.parametrize("argv,error,match", [
        (["ae_recon", "train", "--grad_accum", "2"], None, "grad_accum"),
        (["ae_recon", "train", "--grad_accum", "3"], ValueError, "does not divide"),
        (["ae_transfer", "train", "--pretrained_encoder", "p", "--grad_accum", "2"],
         None, "grad_accum"),
    ])
    def test_train_flags_not_ported_raise(self, tmp_path, monkeypatch, argv, error, match):
        argv = [*argv, "--data_dir", str(tmp_path / "none"), "--output_dir", str(tmp_path / "o"),
                "--device", "cpu"]
        if error is None:  # ported: the value reaches the recipe and its config
            module = ae_recon if argv[0] == "ae_recon" else ae_transfer
            assert reaches_config(monkeypatch, module, argv, tmp_path / "o")[match] == 2
            return
        with pytest.raises(error, match=match):
            cli.main(argv)
        assert not (tmp_path / "o").exists()

    @pytest.mark.parametrize("flags", [["--analyze_latent_space"], ["--visualize_samples", "1"]])
    def test_eval_flags_not_ported_raise(self, tmp_path, flags):
        with pytest.raises(NotImplementedError, match="item 8"):
            cli.main(["ae_recon", "evaluate", "--model_path", str(tmp_path / "m"),
                      "--data_dir", str(tmp_path), "--device", "cpu", *flags])

    @pytest.mark.parametrize("argv", [
        ["ae_recon", "train"], ["ae_transfer", "train", "--pretrained_encoder", "p"]])
    def test_no_card_raises(self, tmp_path, monkeypatch, argv):
        """Without ``--device`` the recipes run on CUDA, and say so when there
        is no card; they do not fall back to the CPU."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main([*argv, "--data_dir", str(tmp_path), "--output_dir", str(tmp_path / "o")])
