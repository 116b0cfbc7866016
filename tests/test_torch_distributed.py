"""The port's data parallelism against JAX's unsharded full-batch step.

Two processes join a gloo process group on the CPU through
``parallel/distributed.py::maybe_initialize_distributed``; this file is its
own worker (``python tests/test_torch_distributed.py --worker RANK PORT
DIR``). The parent writes a global b4 batch at 32² and the weights of a
2-stage UNet (features 8-16, dense, float32, dropout rates 0) to ``DIR``;
rank r takes rows ``[2r, 2r + 2)`` and trains the model wrapped by
``parallel/mesh.py::wrap`` (``DistributedDataParallel``). Against JAX on
the CPU, on the whole batch:

- the data-parallel step, with dynamic class weights on masks whose classes
  differ between the two halves (cats, then dogs), against JAX's
  ``make_segmentation_train_step``; the mean of the halves' own losses (what
  plain DDP would train on) is asserted to differ from the global loss by
  far more than the bound, so the comparison can fail;
- the same with ``grad_accum=2`` (``make_accum_train_step``) against JAX's
  ``make_accum_train_step`` on the global batch;

each rank's updated parameters to 1e-5 relative L2, the global loss each
rank reports to 1e-5 relative (``test_torch_train.py``'s bounds). A CLIP
model's step without ``clip_features`` is refused under the two ranks. Then
one epoch of each of the four recipes under the two ranks (their full-width
models at 512², 2 training images and 1 validation image, a global b2): one
``training_log.csv`` with its row written once, the same trained parameters
on both ranks, and a ``best_model`` that holds them and loads strictly into a
fresh model of its kind. Then ``cli our_unet evaluate --visualize_samples 1`` under
a launcher's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ...; the
file as its own worker again, ``--cli-evaluate RANK PORT DIR``): ``cli.main``
joins the group, both ranks return the same results, and rank 0 alone writes
``evaluation_results.json`` and the figures. In-process: a failed initialization
raises, a single process is a no-op, the mesh's batch split is checked before
the data loads, and ``default_device`` takes the rank's card under a process
group.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path.insert(0, str(REPO))

from unet_implementations_tpu_torch.data.synthetic import as_uint8, synthetic_batch  # noqa: E402
from unet_implementations_tpu_torch.models.unet import UNet  # noqa: E402
from unet_implementations_tpu_torch.parallel import distributed, mesh  # noqa: E402
from unet_implementations_tpu_torch.training import steps, train_state  # noqa: E402

WORLD = 2
GLOBAL_BATCH = 4
SIZE = 32
TINY = dict(features_per_stage=(8, 16), strides=(1, 2), s2d_level0=False,
            s2d_low_channel_decoders=False, encoder_dropout_rates=(0.0, 0.0),
            decoder_dropout_rates=(0.0,))
LOSS_REL = 1e-5
PARAM_REL_L2 = 1e-5
WORKER_TIMEOUT_S = 240
STEPS = ("step", "accum")
RECIPES = ("our_unet", "ae_recon", "ae_transfer", "clip_unet")


def global_batch() -> dict:
    """b4 uint8 images and masks from ``synthetic_batch`` whose halves hold
    different classes: rank 0's two images are cats, rank 1's two dogs (so
    each rank alone has no pixel of the other's class)."""
    batch = as_uint8(synthetic_batch(24, GLOBAL_BATCH, SIZE))
    classes = [set(np.unique(m)) - {0, 255} for m in batch["mask"]]
    assert classes == [{1}, {1}, {2}, {2}], classes
    return {"image": batch["image"], "mask": batch["mask"]}


# ---------------------------------------------------------------------------
# The worker
# ---------------------------------------------------------------------------


def _train_steps(rank: int, d: Path) -> None:
    batch = dict(np.load(d / "batch.npz"))
    rows = slice(rank * GLOBAL_BATCH // WORLD, (rank + 1) * GLOBAL_BATCH // WORLD)
    local = {k: v[rows] for k, v in batch.items()}
    state = torch.load(d / "init.pt")
    for name, accum in zip(STEPS, (1, 2)):
        model = UNet(**TINY)
        model.load_state_dict(state, strict=True)
        wrapped = mesh.wrap(model)
        step = steps.make_accum_train_step(wrapped, train_state.sgd_nesterov(model.parameters()),
                                           steps.make_segmentation_loss_fn(), accum)
        loss = step(local, None)
        torch.save({"params": model.state_dict(), "loss": float(loss)},
                   d / f"{name}_rank{rank}.pt")


def _clip_without_features(rank: int, d: Path) -> None:
    """A CLIP model's data-parallel step on a batch without
    ``clip_features``: the fusion would take no gradient, which DDP's reducer
    refuses, so the step raises before its forward."""
    batch = dict(np.load(d / "batch.npz"))
    local = {k: v[rank * 2:(rank + 1) * 2] for k, v in batch.items()}
    model = UNet(**TINY, clip_fusion=True, clip_dim=8)
    step = steps.make_train_step(mesh.wrap(model), train_state.sgd_nesterov(model.parameters()),
                                 steps.make_segmentation_loss_fn(use_clip=True))
    try:
        step(local, None)
        refused = None
    except ValueError as e:
        refused = str(e)
    (d / f"clip_refused_rank{rank}.json").write_text(json.dumps(refused))


def _train_recipes(d: Path) -> None:
    """One epoch of each recipe at a global b2 (one image a rank); saves
    each rank's result and the parameters of the model the recipe wrapped."""
    from unittest import mock

    from unet_implementations_tpu_torch.recipes import ae_recon, ae_transfer, clip_unet, our_unet

    common = dict(batch_size=2, epochs=1, save_every=1, dtype=torch.float32, device="cpu",
                  num_threads=1, verbose=False)
    runs = {"our_unet": our_unet.train, "ae_recon": ae_recon.train,
            "ae_transfer": lambda *a, **k: ae_transfer.train(
                *a, pretrained_encoder=d / "ae_recon" / "best_model", **k),
            "clip_unet": clip_unet.train}
    for name in RECIPES:
        wrapped = []

        def record(model):
            wrapped.append(model)
            return mesh.wrap(model)

        with mock.patch.object(our_unet, "wrap", record), \
                mock.patch.object(ae_recon, "wrap", record):
            result = runs[name](d / "data", d / name, **common)
        assert len(wrapped) == 1, (name, len(wrapped))
        torch.save({"step": result["step"], "epochs_run": result["epochs_run"],
                    "params": wrapped[0].state_dict()},
                   d / f"{name}_rank{distributed.rank()}.pt")


def cli_evaluate(rank: int, port: int, d: Path) -> None:
    """``cli our_unet evaluate`` as a launcher starts it: the group from the
    environment. Saves the results, the world size the recipe saw and the
    files this rank wrote (JSON dumps and figures)."""
    from unittest import mock

    from matplotlib.figure import Figure

    from unet_implementations_tpu_torch import cli
    from unet_implementations_tpu_torch.recipes import common, our_unet

    torch.set_num_threads(4)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(WORLD),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    seen = {}
    evaluate = our_unet.evaluate

    def recorded(*args, **kwargs):
        seen["world"] = distributed.world_size()
        return evaluate(*args, **kwargs)

    with mock.patch.object(our_unet, "evaluate", recorded), \
            mock.patch.object(common.json, "dump", wraps=json.dump) as dumps, \
            mock.patch.object(Figure, "savefig", autospec=True,
                              side_effect=Figure.savefig) as figures:
        results = cli.main(["our_unet", "evaluate", "--model_path",
                            str(d / "our_unet" / "best_model"), "--data_dir", str(d / "data"),
                            "--output_dir", str(d / "eval"), "--device", "cpu", "--f32",
                            "--batch_size", "2", "--num_workers", "1",
                            "--visualize_samples", "1"])
    assert not distributed.is_initialized()
    (d / f"eval_rank{rank}.json").write_text(json.dumps({
        "results": results, "world": seen["world"], "dumps": dumps.call_count,
        "figures": figures.call_count}))


def worker(rank: int, port: int, d: Path) -> None:
    torch.set_num_threads(4)
    assert distributed.maybe_initialize_distributed(f"tcp://localhost:{port}", WORLD, rank,
                                                    device="cpu")
    try:
        assert (distributed.rank(), distributed.world_size()) == (rank, WORLD)
        assert distributed.is_primary() == (rank == 0)
        _train_steps(rank, d)
        _clip_without_features(rank, d)
        _train_recipes(d)
    finally:
        distributed.shutdown()


# ---------------------------------------------------------------------------
# The parent
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _seeded_params(tree, rng):
    """As ``tests/test_torch_accum.py``: He-scaled kernels, norm scales and
    biases away from their init."""
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


def _write_dataset(root: Path) -> None:
    import cv2

    rng = np.random.default_rng(23)
    for split, labels, n in (("Train", "resized_label", 2), ("Val", "processed_labels", 1),
                             ("Test", "processed_labels", 2)):
        images, masks = root / split / "resized", root / split / labels
        images.mkdir(parents=True)
        masks.mkdir(parents=True)
        for i in range(n):
            cv2.imwrite(str(images / f"{split.lower()}_{i}.jpg"),
                        rng.integers(0, 256, (64, 64, 3)).astype(np.uint8))
            mask = np.zeros((64, 64), np.uint8)
            mask[16:48, 8 + 8 * i:40 + 8 * i] = 1 + i
            cv2.imwrite(str(masks / f"{split.lower()}_{i}.png"), mask)


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """The JAX state and batch, and the two workers' outputs."""
    import jax
    import jax.numpy as jnp

    from unet_implementations_tpu.models.unet import UNet as JaxUNet
    from unet_implementations_tpu.training import train_state as jax_ts
    from unet_implementations_tpu_torch.models import convert

    d = tmp_path_factory.mktemp("dp")
    batch = global_batch()
    np.savez(d / "batch.npz", **batch)
    jmodel = JaxUNet(**TINY)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0),
                            jnp.zeros((1, SIZE, SIZE, 3), jnp.float32))["params"]
    params = jax.tree.map(jnp.asarray, _seeded_params(shapes, np.random.default_rng(24)))
    tx = jax_ts.sgd_nesterov()
    state = jax_ts.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                              opt_state=tx.init(params), tx=tx, apply_fn=jmodel.apply)
    model = UNet(**TINY)
    model.load_state_dict(convert.params_from_jax(jax.device_get(params), model), strict=True)
    torch.save(model.state_dict(), d / "init.pt")
    _write_dataset(d / "data")

    _run_workers("--worker", d)
    return {"dir": d, "state": state, "batch": batch, "model": model}


def _run_workers(mode: str, d: Path) -> None:
    """This file as WORLD workers in ``mode``, on a fresh port; each must exit 0."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = os.pathsep.join([str(REPO)] + [p for p in env.get(
        "PYTHONPATH", "").split(os.pathsep) if p])
    env["UNET_TPU_DECODE_CACHE"] = ""
    procs = [subprocess.Popen([sys.executable, __file__, mode, str(rank), str(port), str(d)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              cwd=REPO, env=env)
             for rank in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("name", STEPS)
def test_data_parallel_step_matches_jax_full_batch(dp_run, name):
    import jax
    import jax.numpy as jnp

    from unet_implementations_tpu.training import steps as jax_steps
    from unet_implementations_tpu_torch.models import convert

    state, model = dp_run["state"], dp_run["model"]
    jbatch = {k: jnp.asarray(v) for k, v in dp_run["batch"].items()}
    if name == "step":
        jstep = jax_steps.make_segmentation_train_step(donate=False)
    else:
        jstep = jax_steps.make_accum_train_step(jax_steps.make_segmentation_loss_fn(), 2,
                                                donate=False)
    want_state, want_loss = jstep(state, jbatch, jax.random.key(0))
    want = convert.params_from_jax(jax.device_get(want_state.params), model)
    for rank in range(WORLD):
        got = torch.load(dp_run["dir"] / f"{name}_rank{rank}.pt")
        assert abs(got["loss"] - float(want_loss)) <= LOSS_REL * abs(float(want_loss)), rank
        for key, value in got["params"].items():
            assert _rel_l2(value.numpy(), want[key].numpy()) <= PARAM_REL_L2, (rank, key)

    if name == "step":
        # What plain DDP would train on: each rank's own loss (its own class
        # weights and CE denominator), averaged. It must differ from the
        # global loss by far more than the bound, or this test could not
        # tell the two apart.
        loss_fn = jax.jit(lambda b: jax_steps.make_segmentation_loss_fn()(
            state, state.params, b, jax.random.key(0)))
        halves = [{k: v[r * 2:(r + 1) * 2] for k, v in jbatch.items()} for r in range(WORLD)]
        per_rank = float(np.mean([float(loss_fn(h)) for h in halves]))
        global_loss = float(loss_fn(jbatch))
        assert abs(per_rank - global_loss) > 100 * LOSS_REL * global_loss, (per_rank,
                                                                          global_loss)


def test_clip_model_without_features_is_refused(dp_run):
    for rank in range(WORLD):
        refused = json.loads((dp_run["dir"] / f"clip_refused_rank{rank}.json").read_text())
        assert refused is not None and "only with clip_features" in refused, (rank, refused)


@pytest.mark.parametrize("name", RECIPES)
def test_recipe_epoch_under_two_ranks(dp_run, name):
    from unet_implementations_tpu_torch.models import convert

    run = dp_run["dir"] / name
    lines = (run / "training_log.csv").read_text().splitlines()
    assert len(lines) == 2 and lines[1].startswith("1,"), lines
    assert json.loads((run / "training_config.json").read_text())["batch_size"] == 2
    ranks = [torch.load(dp_run["dir"] / f"{name}_rank{r}.pt") for r in range(WORLD)]
    # 2 training images over 2 ranks at a global b2: one step each.
    assert [(r["step"], r["epochs_run"]) for r in ranks] == [(1, 1)] * WORLD
    params = ranks[0]["params"]
    for key, value in ranks[1]["params"].items():
        assert torch.equal(value, params[key]), key
    sd = torch.load(run / "best_model" / "model.pth", weights_only=True)["model_state_dict"]
    assert not any(k.startswith("module.") for k in sd)
    assert sd.keys() == params.keys()
    for key, value in sd.items():
        assert torch.equal(value, params[key]), key
    convert.load_reference_checkpoint(run / "best_model" / "model.pth", device="cpu",
                                      dtype=torch.float32, arch=name)


def test_evaluate_under_a_launcher(dp_run):
    """Both ranks joined (the recipe saw a world of 2) and return the same
    results; rank 0 alone wrote the results and the figures (the prediction
    triptych, the error map, the confidence map, the confusion matrix)."""
    d = dp_run["dir"]
    _run_workers("--cli-evaluate", d)
    ranks = [json.loads((d / f"eval_rank{r}.json").read_text()) for r in range(WORLD)]
    assert [r["world"] for r in ranks] == [WORLD] * WORLD
    assert ranks[0]["results"] == ranks[1]["results"]
    assert ranks[0]["results"] == json.loads((d / "eval" / "evaluation_results.json").read_text())
    assert [(r["dumps"], r["figures"]) for r in ranks] == [(1, 4), (0, 0)]
    assert sorted(p.name for p in (d / "eval" / "visualizations").iterdir()) == [
        "confidence_batch0.png", "confusion_matrix.png", "error_analysis_batch0.png",
        "predictions_batch0.png"]


def test_failed_initialization_raises():
    # Rank 1 of 2 finds no rank 0 at the address.
    with pytest.raises(RuntimeError, match="initialization failed"):
        distributed.maybe_initialize_distributed(f"tcp://localhost:{_free_port()}", 2, 1,
                                                 device="cpu", timeout_s=1)
    with pytest.raises(RuntimeError, match="initialization failed"):
        distributed.maybe_initialize_distributed(f"tcp://localhost:{_free_port()}", 1, 0,
                                                 backend="no-such-backend", device="cpu")
    assert not distributed.is_initialized()


def test_single_process_is_a_no_op(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    assert distributed.maybe_initialize_distributed(device="cpu") is False
    assert (distributed.rank(), distributed.world_size(), distributed.is_primary()) == (0, 1, True)
    assert mesh.create_mesh("cpu") is None


def test_check_grad_accum_covers_the_ranks(monkeypatch):
    from unet_implementations_tpu_torch.recipes import common

    monkeypatch.setattr(common, "world_size", lambda: 2)
    common.check_grad_accum(8, 2, use_mesh=True)  # 2 ranks x 2 microbatches of 2
    common.check_grad_accum(6, 2, use_mesh=False)
    with pytest.raises(ValueError, match="does not divide into 2 ranks x 2"):
        common.check_grad_accum(6, 2, use_mesh=True)
    with pytest.raises(ValueError, match="does not divide into 2 ranks x 1"):
        common.check_grad_accum(3, 1, use_mesh=True)


def test_default_device_takes_the_ranks_card(monkeypatch):
    from unet_implementations_tpu_torch import default_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert default_device() == torch.device("cuda")
    monkeypatch.setattr(distributed, "is_initialized", lambda: True)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert default_device() == torch.device("cuda", 3)
    # Without LOCAL_RANK: the card the group was joined on (the current one),
    # whatever the rank.
    monkeypatch.delenv("LOCAL_RANK")
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert default_device() == torch.device("cuda", 0)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert default_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_device()


if __name__ == "__main__":
    modes = {"--worker": worker, "--cli-evaluate": cli_evaluate}
    if sys.argv[1:2] not in [[m] for m in modes]:
        sys.exit("usage: test_torch_distributed.py --worker|--cli-evaluate RANK PORT DIR")
    modes[sys.argv[1]](int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
