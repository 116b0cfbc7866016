"""The port's training loop and checkpoints (unet_implementations_tpu_torch)
against the JAX package's.

- ``train_loop`` against JAX's on a tiny UNet (features 8-16, strides 1-2,
  dropout rates 0, float32, the JAX weights through ``params_from_jax``) and
  synthetic batches at 32², 2 epochs: the epoch and learning-rate fields
  equal as text, the losses to 1e-4 relative, the Dice columns to 1e-4
  absolute, and the same checkpoint directory names.
- Resume, with dropout on: one epoch and a resume of one epoch equal an
  uninterrupted two-epoch run (the CSV rows apart from ``epoch_time``, and
  the final weights bit for bit), because step n's dropout is seeded from
  the global step the checkpoint keeps.
- The cases of ``tests/test_loop.py``: a best model at a metric of 0, stale
  and malformed CSV rows on resume, the stop epoch on resume, the
  reconstruction CSV schema with the checkpoint callback.
- Checkpoints: the reference ``.pth`` schema under ``weights_only=True``,
  model and optimizer round trips, ``restore_params`` on a directory, a
  ``.pth`` and a bare state dict, ``extract_encoder_params``.
"""

import csv
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_implementations_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from unet_implementations_tpu.models.unet import UNet as JaxUNet
from unet_implementations_tpu.training import loop as jax_loop
from unet_implementations_tpu.training import poly_lr as jax_poly_lr
from unet_implementations_tpu.training import steps as jax_steps
from unet_implementations_tpu.training import train_state as jax_ts
from unet_implementations_tpu_torch.data.synthetic import synthetic_batch
from unet_implementations_tpu_torch.models import convert
from unet_implementations_tpu_torch.models.unet import UNet
from unet_implementations_tpu_torch.training import checkpoint, loop, steps
from unet_implementations_tpu_torch.training.train_state import poly_lr, sgd_nesterov

TINY = dict(features_per_stage=(8, 16), strides=(1, 2),
            encoder_dropout_rates=(0.0, 0.0), decoder_dropout_rates=(0.0,))
TINY_DROPOUT = dict(TINY, encoder_dropout_rates=(0.0, 0.3), decoder_dropout_rates=(0.2,))
SIZE = 32


def batches():
    def train_batches(epoch):
        for i in range(2):
            yield synthetic_batch(epoch * 10 + i, 4, SIZE)

    def val_batches():
        for i in range(2):
            yield synthetic_batch(1000 + i, 4, SIZE)

    return train_batches, val_batches


def port_run(model, **kw):
    optimizer = sgd_nesterov(model.parameters())
    tb, vb = batches()
    args = dict(train_step=steps.make_segmentation_train_step(model, optimizer),
                eval_step=steps.make_segmentation_eval_step(model),
                train_batches=tb, val_batches=vb, verbose=False)
    args.update(kw)
    return loop.train_loop(model, optimizer, **args), optimizer


def read_rows(path):
    with open(path / "training_log.csv") as f:
        return list(csv.DictReader(f))


def checkpoint_dirs(root):
    return sorted(str(p.relative_to(root)) for p in [*root.glob("checkpoints/*"),
                                                     *root.glob("best_model")])


def test_headers_equal_jax():
    assert loop.SEG_CSV_HEADER == jax_loop.SEG_CSV_HEADER
    assert loop.AE_CSV_HEADER == jax_loop.AE_CSV_HEADER


class TestAgainstJax:
    def test_two_epochs_match_jax(self, tmp_path):
        jmodel = JaxUNet(**TINY)
        # One jit of init (an eager init compiles op by op).
        params = jax.jit(jmodel.init)(
            jax.random.key(3), jnp.asarray(jax_synthetic_batch(0, 2, SIZE)["image"]))["params"]
        tx = jax_ts.sgd_nesterov()
        state = jax_ts.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                  opt_state=tx.init(params), tx=tx, apply_fn=jmodel.apply)
        model = UNet(**TINY)
        model.load_state_dict(convert.params_from_jax(jax.device_get(state.params), model),
                              strict=True)
        tb, vb = batches()
        jax_loop.train_loop(
            state, train_step=jax_steps.make_segmentation_train_step(donate=False),
            eval_step=jax_steps.make_segmentation_eval_step(), train_batches=tb,
            val_batches=vb, lr_schedule=jax_poly_lr(5e-3, 2), epochs=2,
            output_dir=tmp_path / "jax", save_every=1, verbose=False)
        result, _ = port_run(model, lr_schedule=poly_lr(5e-3, 2), epochs=2,
                             output_dir=tmp_path / "port", save_every=1)
        assert result["epochs_run"] == 2 and result["step"] == 4
        assert [e["steps"] for e in result["epochs"]] == [2, 2]
        ours, ref = read_rows(tmp_path / "port"), read_rows(tmp_path / "jax")
        assert len(ours) == len(ref) == 2
        for a, b in zip(ours, ref):
            assert list(a) == list(b)
            assert a["epoch"] == b["epoch"] and a["learning_rate"] == b["learning_rate"]
            for k in ("train_loss", "val_loss"):
                assert abs(float(a[k]) - float(b[k])) <= 1e-4 * abs(float(b[k])), k
            for k in ("dice_background", "dice_cat", "dice_dog", "dice_mean_foreground"):
                assert abs(float(a[k]) - float(b[k])) <= 1e-4, k
        assert checkpoint_dirs(tmp_path / "port") == checkpoint_dirs(tmp_path / "jax")
        meta = json.loads((tmp_path / "port" / "best_model" / "meta.json").read_text())
        ref_meta = json.loads((tmp_path / "jax" / "best_model" / "meta.json").read_text())
        assert meta.keys() == ref_meta.keys()


class TestResume:
    def test_resume_equals_uninterrupted(self, tmp_path):
        """With dropout on: epoch 1, then a resume from its checkpoint for
        epoch 2, equals an uninterrupted two-epoch run."""
        common = dict(lr_schedule=poly_lr(5e-3, 2), save_every=1, dropout_seed=5)
        full_model = UNet(**TINY_DROPOUT, generator=torch.Generator().manual_seed(1))
        port_run(full_model, epochs=2, output_dir=tmp_path / "full", **common)

        first = UNet(**TINY_DROPOUT, generator=torch.Generator().manual_seed(1))
        port_run(first, epochs=1, output_dir=tmp_path / "resumed", **common)
        model = UNet(**TINY_DROPOUT, generator=torch.Generator().manual_seed(9))
        optimizer = sgd_nesterov(model.parameters())
        meta = checkpoint.restore_checkpoint(tmp_path / "resumed" / "checkpoints" / "epoch_1",
                                             model, optimizer)
        assert meta["epoch"] == 1 and meta["step"] == 2
        tb, vb = batches()
        loop.train_loop(
            model, optimizer, train_step=steps.make_segmentation_train_step(model, optimizer),
            eval_step=steps.make_segmentation_eval_step(model), train_batches=tb,
            val_batches=vb, epochs=2, output_dir=tmp_path / "resumed", verbose=False,
            start_epoch=meta["epoch"], step=meta["step"], best_metric=meta["best_metric"],
            early_stopping_state=meta["early_stopping"], **common)

        def rows(name):
            return [{k: v for k, v in r.items() if k != "epoch_time"}
                    for r in read_rows(tmp_path / name)]

        assert rows("resumed") == rows("full")
        for (key, a), b in zip(model.state_dict().items(), full_model.state_dict().values()):
            assert torch.equal(a, b), key

    def test_dropout_generator_is_per_step(self):
        draw = [torch.rand(4, generator=loop.dropout_generator(5, s, torch.device("cpu")))
                for s in (0, 1, 0)]
        assert torch.equal(draw[0], draw[2]) and not torch.equal(draw[0], draw[1])
        other = torch.rand(4, generator=loop.dropout_generator(6, 0, torch.device("cpu")))
        assert not torch.equal(draw[0], other)


class TestLoopContract:
    """The cases of tests/test_loop.py, on the port."""

    def test_artifacts_and_schema(self, tmp_path):
        result, _ = port_run(UNet(**TINY), lr_schedule=poly_lr(5e-3, 3), epochs=3,
                             output_dir=tmp_path, save_every=10, patience=15)
        assert result["epochs_run"] == 3
        rows = read_rows(tmp_path)
        assert list(rows[0]) == loop.SEG_CSV_HEADER.split(",")
        assert rows[1]["learning_rate"] == f"{5e-3 * (2 / 3) ** 0.9:.7f}"
        assert (tmp_path / "best_model" / checkpoint.MODEL_FILE).exists()

    def test_best_model_written_even_for_zero_metric(self, tmp_path):
        model = UNet(**TINY)
        real = steps.make_segmentation_eval_step(model)

        def zero_dice_eval(batch):
            return dict(real(batch), dice=torch.zeros(3))

        port_run(model, eval_step=zero_dice_eval, lr_schedule=poly_lr(5e-3, 1), epochs=1,
                 output_dir=tmp_path)
        assert (tmp_path / "best_model" / checkpoint.MODEL_FILE).exists()
        assert checkpoint.read_meta(tmp_path / "best_model")["best_metric"] == 0.0

    @pytest.mark.parametrize("stale,want", [
        ([f"{e},1.0,1.0,0.1,0.1,0.1,0.1,0.005,1.0" for e in (1, 2, 3, 4)], ["1", "2", "3", "4"]),
        (["1,1.0,1.0,0.1,0.1,0.1,0.1,0.005,1.0", "garbage,row", loop.SEG_CSV_HEADER,
          "2,1.0,1.0,0.1,0.1,0.1,0.1,0.005,"], ["1", "2", "3", "4"]),
    ], ids=["stale_rows", "malformed_rows"])
    def test_resume_truncates_csv(self, tmp_path, stale, want):
        (tmp_path / "training_log.csv").write_text(
            "\n".join([loop.SEG_CSV_HEADER, *stale]) + "\n")
        port_run(UNet(**TINY), lr_schedule=poly_lr(5e-3, 4), epochs=4, output_dir=tmp_path,
                 start_epoch=2, best_metric=0.1)
        rows = read_rows(tmp_path)
        assert [r["epoch"] for r in rows] == want
        assert rows[2]["train_loss"] != "1.0"

    def test_resume_reproduces_stop_epoch(self, tmp_path):
        model = UNet(**TINY)
        real = steps.make_segmentation_eval_step(model)

        def flat_eval(batch):
            return dict(real(batch), dice=torch.tensor([0.5, 0.5, 0.5]))

        common = dict(eval_step=flat_eval, lr_schedule=poly_lr(5e-3, 10), epochs=10,
                      save_every=1, patience=3)
        full, _ = port_run(model, output_dir=tmp_path / "full", **common)
        assert full["epochs_run"] == 4  # epoch 1 sets the best; 2-4 count 1..3

        port_run(UNet(**TINY), output_dir=tmp_path / "resumed", **common)
        model = UNet(**TINY)
        optimizer = sgd_nesterov(model.parameters())
        meta = checkpoint.restore_checkpoint(tmp_path / "resumed" / "checkpoints" / "epoch_2",
                                             model, optimizer)
        assert meta["early_stopping"]["counter"] == 1
        tb, vb = batches()
        resumed = loop.train_loop(
            model, optimizer, train_step=steps.make_segmentation_train_step(model, optimizer),
            train_batches=tb, val_batches=vb, output_dir=tmp_path / "resumed", verbose=False,
            start_epoch=meta["epoch"], step=meta["step"], best_metric=meta["best_metric"],
            early_stopping_state=meta["early_stopping"], **common)
        assert resumed["epochs_run"] == full["epochs_run"]

    def test_reconstruction_schema_and_callback(self, tmp_path):
        model = UNet(**TINY)
        calls = []

        def recon_eval(batch):
            return {"loss": torch.tensor(0.5), "mse": torch.full((4,), 0.25),
                    "psnr": torch.full((4,), 6.0)}

        result, _ = port_run(model, eval_step=recon_eval, lr_schedule=poly_lr(1e-3, 2),
                             epochs=2, output_dir=tmp_path, task="reconstruction",
                             save_every=1,
                             checkpoint_callback=lambda m, e: calls.append((m is model, e)))
        rows = read_rows(tmp_path)
        assert list(rows[0]) == loop.AE_CSV_HEADER.split(",")
        assert rows[0]["val_mse"] == "0.250000" and rows[0]["val_psnr"] == "6.0000"
        assert calls == [(True, 1), (True, 2)]
        assert result["best_metric"] == pytest.approx(0.5)

    def test_profile_dir_writes_trace(self, tmp_path):
        result, _ = port_run(UNet(**TINY), lr_schedule=poly_lr(5e-3, 1), epochs=1,
                             output_dir=tmp_path / "run", profile_dir=tmp_path / "prof")
        trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
        assert trace["traceEvents"]
        assert result["epochs"][0]["steps"] == 2

    def test_to_device_on_the_cpu(self):
        """On the CPU a batch is not pinned: no card is asked for."""
        host = np.arange(12, dtype=np.int32).reshape(3, 4)
        moved = steps.to_device(host, torch.device("cpu"))
        assert moved.device.type == "cpu" and not moved.is_pinned()
        np.testing.assert_array_equal(moved.numpy(), host)

    def test_validate_empty(self):
        assert loop.validate(lambda b: None, [])["batches"] == 0


class TestCheckpoint:
    def _trained(self):
        model = UNet(**TINY_DROPOUT)
        optimizer = sgd_nesterov(model.parameters())
        step = steps.make_segmentation_train_step(model, optimizer)
        step(synthetic_batch(0, 2, SIZE), torch.Generator().manual_seed(0))
        return model, optimizer

    def test_schema_and_round_trip(self, tmp_path):
        model, optimizer = self._trained()
        es = {"counter": 2, "best_score": 0.25}
        checkpoint.save_checkpoint(tmp_path / "ck", model, optimizer, 3, 0.25,
                                   {"n_stages": 2}, early_stopping=es, step=7)
        ckpt = torch.load(str(tmp_path / "ck" / "model.pth"), weights_only=True)
        assert {"epoch", "model_state_dict", "best_dice", "config"} <= ckpt.keys()
        assert ckpt["epoch"] == 3 and ckpt["best_dice"] == 0.25 and ckpt["step"] == 7
        assert all(v.dtype == torch.float32 and v.device.type == "cpu"
                   for v in ckpt["model_state_dict"].values())
        assert checkpoint.read_meta(tmp_path / "ck") == {
            "epoch": 3, "best_metric": 0.25, "config": {"n_stages": 2}, "early_stopping": es}

        fresh = UNet(**TINY_DROPOUT, generator=torch.Generator().manual_seed(4))
        fresh_opt = sgd_nesterov(fresh.parameters())
        meta = checkpoint.restore_checkpoint(tmp_path / "ck", fresh, fresh_opt)
        assert meta["epoch"] == 3 and meta["step"] == 7 and meta["early_stopping"] == es
        for a, b in zip(fresh.state_dict().values(), model.state_dict().values()):
            assert torch.equal(a, b)
        for p, q in zip(fresh.parameters(), model.parameters()):
            assert torch.equal(fresh_opt.state[p]["momentum_buffer"],
                               optimizer.state[q]["momentum_buffer"])

    def test_restore_params_sources(self, tmp_path):
        model, optimizer = self._trained()
        checkpoint.save_checkpoint(tmp_path / "ck", model, optimizer, 1, 0.5)
        torch.save(model.state_dict(), str(tmp_path / "bare.pth"))
        for source in (tmp_path / "ck", tmp_path / "ck" / "model.pth", tmp_path / "bare.pth"):
            fresh = checkpoint.restore_params(
                source, UNet(**TINY_DROPOUT, generator=torch.Generator().manual_seed(4)))
            for a, b in zip(fresh.state_dict().values(), model.state_dict().values()):
                assert torch.equal(a, b)

    def test_extract_encoder_params(self, tmp_path):
        source, optimizer = self._trained()
        checkpoint.save_checkpoint(tmp_path / "ck", source, optimizer, 1, 0.5)
        target = UNet(**TINY_DROPOUT, generator=torch.Generator().manual_seed(4))
        before = {k: v.clone() for k, v in target.state_dict().items()}
        checkpoint.extract_encoder_params(tmp_path / "ck", target, n_stages=2)
        for key, value in target.state_dict().items():
            want = source.state_dict()[key] if key.startswith("encoder_stages.") else before[key]
            assert torch.equal(value, want), key
        wide = UNet(features_per_stage=(8, 24), strides=(1, 2),
                    encoder_dropout_rates=(0.0, 0.3), decoder_dropout_rates=(0.2,))
        with pytest.raises(ValueError):
            checkpoint.extract_encoder_params(tmp_path / "ck", wide, n_stages=2)
