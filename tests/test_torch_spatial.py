"""The port's spatial partitioning against JAX's unsharded and spatial programs.

Processes join a gloo process group on the CPU; this file is its own worker
(``python tests/test_torch_spatial.py --worker RANK PORT DIR`` and ``--cli
RANK PORT DIR``). Two launches run at once:

- four ranks on a tiny dense UNet (3 stages, features 8-16-32, strides
  1-2-2, float32, dropout rates 0) at 32², first on a (data 2, space 2) grid,
  then, regrouped by ``new_group``, on a (data 1, space 4) grid, each over a
  global b4 batch whose masks put cats in the top rows and dogs in the
  bottom rows. Against JAX on the CPU with the same weights (``convert``):
  the spatial forward against JAX's unsharded forward (rel-L2 1e-5) and
  against JAX's own ``spatial_forward_jit`` on conftest's 8-device platform
  (max |Δ| 5e-4, ``tests/test_spatial.py``'s ``TOL``); the spatial train
  step against JAX's unsharded ``make_segmentation_train_step`` on the
  global batch (loss 1e-5 relative, each rank's updated parameters 1e-5
  relative L2, ``test_torch_distributed.py``'s bounds). The shards run
  without the groups (local statistics, zero rows at the shard edges, local
  Dice and class weights) must miss both by far more, so the comparisons
  can fail. The halo exchange's backward is its transpose across ranks, and
  a grid the world does not divide into is refused;
- two ranks running ``cli our_unet train --spatial 2`` for one epoch
  (full-width ``unet_6stage`` at 512², 2 training and 1 validation image,
  float32), then ``cli predict --spatial 2`` with its ``best_model``: one
  CSV row, the same parameters on both ranks, a strict ``best_model``, and
  masks equal to one process's ``predict``.

The four ranks also run, on both grids, three more models (``MODELS``): an
s2d one (3 stages, features 8-32-32: level 0 in s2d and decoder_0 wrapped,
so both decoders are s2d), with the upsample fold off and on
(``UNET_TPU_S2D_UP_FOLD``), and the tiny dense model at ``kernel_size=5``
(two halo rows a side, shards of two rows at the bottleneck on the (1, 4)
grid). Each spatial forward against JAX's unsharded forward (1e-5) and
``spatial_forward_jit`` (5e-4), under the same policy; the s2d model's step
with the fold on against JAX's unsharded step with the fold on, at the
dense model's bounds.

In-process: K2a's and K2b's plain versions on halo'd shards equal the rows
of the unsharded upsample bit for bit, and the refusals that need no group
(an indivisible height, a k = 5 shard too shallow for its halo, ``--spatial``
with ``--grad_accum``).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path.insert(0, str(REPO))

from unet_implementations_tpu_torch import cli  # noqa: E402
from unet_implementations_tpu_torch.kernels.upsample import (  # noqa: E402
    upsample2x_into_s2d_fast,
    upsample2x_into_s2d_halo,
    upsample2x_nhwc_fast,
    upsample2x_nhwc_halo,
)
from unet_implementations_tpu_torch.models.unet import UNet  # noqa: E402
from unet_implementations_tpu_torch.ops.losses import segmentation_loss  # noqa: E402
from unet_implementations_tpu_torch.ops.normalize import normalize_image  # noqa: E402
from unet_implementations_tpu_torch.parallel import distributed, spatial  # noqa: E402
from unet_implementations_tpu_torch.training import train_state  # noqa: E402

WORLD = 4
CLI_WORLD = 2
GLOBAL_BATCH = 4
SIZE = 32
TINY = dict(features_per_stage=(8, 16, 32), strides=(1, 2, 2), s2d_level0=False,
            s2d_low_channel_decoders=False, encoder_dropout_rates=(0.0,) * 3,
            decoder_dropout_rates=(0.0,) * 2)
# The further models of the four-rank launch: (config, the s2d fold on).
S2D_TINY = dict(TINY, features_per_stage=(8, 32, 32), s2d_level0=True,
                s2d_low_channel_decoders=True)
MODELS = {"s2d": (S2D_TINY, False), "s2d_fold": (S2D_TINY, True),
          "k5": (dict(TINY, kernel_size=5), False)}
FOLD_VAR = "UNET_TPU_S2D_UP_FOLD"
# (n_data, n_space) of the four-rank launch, in its order.
GRIDS = {"dp2_sp2": (2, 2), "dp1_sp4": (1, 4)}
FWD_REL_L2 = 1e-5
JAX_SPATIAL_TOL = 5e-4
LOSS_REL = 1e-5
PARAM_REL_L2 = 1e-5
WORKER_TIMEOUT_S = 240


def global_batch() -> dict:
    """b4 at 32²: float images for the forward, uint8 images and masks for
    the step. Each mask holds a cat in its top rows and a dog in its bottom
    rows inside an ignored border, so a space rank alone sees one class."""
    rng = np.random.default_rng(31)
    mask = np.zeros((GLOBAL_BATCH, SIZE, SIZE), np.int32)
    for i in range(GLOBAL_BATCH):
        mask[i, 2 + i:13, 3:20 + 2 * i] = 1
        mask[i, 19:29 - i, 6 + i:28] = 2
    mask[:, :, :2] = 255
    mask[:, -2:, :] = 255
    return {"x": rng.normal(size=(GLOBAL_BATCH, SIZE, SIZE, 3)).astype(np.float32),
            "image": rng.integers(0, 256, (GLOBAL_BATCH, SIZE, SIZE, 3)).astype(np.uint8),
            "mask": mask}


# ---------------------------------------------------------------------------
# The workers
# ---------------------------------------------------------------------------


def _model(d: Path, name: str = "tiny") -> UNet:
    model = UNet(**(TINY if name == "tiny" else MODELS[name][0]))
    model.load_state_dict(torch.load(d / f"init_{name}.pt"), strict=True)
    return model


def _models_run(grid, batch: dict, d: Path) -> None:
    """The further models' spatial forwards on this grid, and the folded s2d
    model's step; saves what the parent compares."""
    out = {"data_rank": grid.data_rank}
    for name, (_, fold) in MODELS.items():
        os.environ[FOLD_VAR] = "1" if fold else "0"
        model = _model(d, name)
        out[name] = spatial.gather_rows(spatial.spatial_forward(model, grid, batch["x"]),
                                        grid.context)
        if fold:
            step = spatial.spatial_train_step(model, train_state.sgd_nesterov(
                model.parameters()), grid)
            out[f"{name} loss"] = float(step({"image": batch["image"], "mask": batch["mask"]},
                                             None))
            out[f"{name} params"] = model.state_dict()
    os.environ.pop(FOLD_VAR)
    n_data, n_space = grid.n_data, grid.n_space
    torch.save(out, d / f"models_dp{n_data}_sp{n_space}_rank{grid.rank}.pt")


def _grid_run(name: str, d: Path) -> None:
    """One grid's forward, train step and their controls, then the further
    models'; saves what the parent compares."""
    n_data, n_space = GRIDS[name]
    grid = spatial.create_mesh_dp_sp(n_space, n_data, device="cpu")
    ctx = grid.context
    b = GLOBAL_BATCH // n_data
    batch = {k: torch.from_numpy(v[grid.data_rank * b:(grid.data_rank + 1) * b])
             for k, v in np.load(d / "batch.npz").items()}
    _models_run(grid, batch, d)
    model = _model(d)
    logits = spatial.gather_rows(spatial.spatial_forward(model, grid, batch["x"]), ctx)
    with torch.no_grad():  # the control: the shards alone
        alone = spatial.gather_rows(model(spatial.rows_of(batch["x"], ctx)), ctx)

    step = spatial.spatial_train_step(model, train_state.sgd_nesterov(model.parameters()), grid)
    loss = float(step({"image": batch["image"], "mask": batch["mask"]}, None))
    with torch.no_grad():  # the control: the shards' own losses
        own = _model(d)
        image = normalize_image(spatial.rows_of(batch["image"], ctx))
        own_loss = float(segmentation_loss(own(image), spatial.rows_of(batch["mask"], ctx)))
    torch.save({"data_rank": grid.data_rank, "logits": logits, "alone": alone, "loss": loss,
                "own_loss": own_loss, "params": model.state_dict()},
               d / f"{name}_rank{grid.rank}.pt")


def _halo_transpose(d: Path) -> None:
    """<halo(x), g> and <x, haloᵀ(g)> on this rank, over the (1, 4) grid."""
    grid = spatial.create_mesh_dp_sp(4, device="cpu")
    rng = np.random.default_rng([41, grid.rank])
    x = torch.from_numpy(rng.normal(size=(2, 3, 5, 4))).float().requires_grad_(True)
    g = [torch.from_numpy(rng.normal(size=(2, 1, 5, 4))).float() for _ in range(2)]
    above, below = spatial.halo_rows(x, grid.context)
    inner = (above * g[0]).sum() + (below * g[1]).sum()
    inner.backward()
    refused = None
    try:
        spatial.create_mesh_dp_sp(3, device="cpu")
    except ValueError as e:
        refused = str(e)
    torch.save({"forward": float(inner), "transpose": float((x.detach() * x.grad).sum()),
                "refused": refused}, d / f"halo_rank{grid.rank}.pt")


def worker(rank: int, port: int, d: Path) -> None:
    torch.set_num_threads(1)
    assert distributed.maybe_initialize_distributed(f"tcp://localhost:{port}", WORLD, rank,
                                                    device="cpu")
    try:
        for name in GRIDS:
            _grid_run(name, d)
        _halo_transpose(d)
    finally:
        distributed.shutdown()


def cli_worker(rank: int, port: int, d: Path) -> None:
    """``cli our_unet train --spatial 2`` for one epoch, then ``cli predict
    --spatial 2`` with its best model; saves the trained parameters."""
    from unet_implementations_tpu_torch.recipes import our_unet

    torch.set_num_threads(2)
    assert distributed.maybe_initialize_distributed(f"tcp://localhost:{port}", CLI_WORLD, rank,
                                                    device="cpu")
    try:
        wrapped = []

        def record(model, grid):
            wrapped.append(model)
            return spatial.SpatialParallel(model, grid)

        run = d / "run"
        with mock.patch.object(our_unet, "SpatialParallel", record):
            result = cli.main(["our_unet", "train", "--data_dir", str(d / "data"),
                               "--output_dir", str(run), "--device", "cpu", "--f32",
                               "--batch_size", "2", "--epochs", "1", "--save_every", "1",
                               "--num_threads", "1", "--spatial", str(CLI_WORLD)])
        torch.save({"step": result["step"], "epochs_run": result["epochs_run"],
                    "params": wrapped[0].state_dict()}, d / f"cli_rank{rank}.pt")
        n = cli.main(["predict", "--model_path", str(run / "best_model" / "model.pth"),
                      "--input", str(d / "predict_in"), "--output_dir", str(d / "predict_sp"),
                      "--device", "cpu", "--f32", "--no_overlay", "--spatial", str(CLI_WORLD)])
        (d / f"predict_rank{rank}.json").write_text(json.dumps(n))
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
    """As ``tests/test_torch_distributed.py``: He-scaled kernels, norm scales
    and biases away from their init."""
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


def _write_cli_data(d: Path) -> None:
    import cv2

    rng = np.random.default_rng(37)
    for split, labels, n in (("Train", "resized_label", 2), ("Val", "processed_labels", 1)):
        images, masks = d / "data" / split / "resized", d / "data" / split / labels
        images.mkdir(parents=True)
        masks.mkdir(parents=True)
        for i in range(n):
            cv2.imwrite(str(images / f"{split.lower()}_{i}.jpg"),
                        rng.integers(0, 256, (64, 64, 3)).astype(np.uint8))
            mask = np.zeros((64, 64), np.uint8)
            mask[8:28, 8 + 8 * i:40 + 8 * i] = 1
            mask[36:56, 12:44] = 2
            cv2.imwrite(str(masks / f"{split.lower()}_{i}.png"), mask)
    (d / "predict_in").mkdir()
    for i, shape in enumerate([(60, 44, 3), (96, 80, 3)]):
        cv2.imwrite(str(d / "predict_in" / f"p{i}.jpg"),
                    rng.integers(0, 256, shape).astype(np.uint8))


def _launch(mode: str, world: int, d: Path, env: dict) -> list:
    port = _free_port()
    return [subprocess.Popen([sys.executable, __file__, mode, str(rank), str(port), str(d)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                             cwd=REPO, env=env)
            for rank in range(world)]


@pytest.fixture(scope="module")
def sp_run(tmp_path_factory):
    """The JAX state and batch, and the workers' outputs."""
    import jax
    import jax.numpy as jnp

    from unet_implementations_tpu.models.unet import UNet as JaxUNet
    from unet_implementations_tpu.training import train_state as jax_ts
    from unet_implementations_tpu_torch.models import convert

    d = tmp_path_factory.mktemp("spatial")
    batch = global_batch()
    np.savez(d / "batch.npz", **batch)
    models = {}
    for i, (name, config) in enumerate([("tiny", TINY)] + [(n, c) for n, (c, _) in
                                                          MODELS.items()]):
        jmodel = JaxUNet(**config)
        shapes = jax.eval_shape(jmodel.init, jax.random.key(0),
                                jnp.zeros((1, SIZE, SIZE, 3), jnp.float32))["params"]
        params = jax.tree.map(jnp.asarray,
                              _seeded_params(shapes, np.random.default_rng(29 + i)))
        tx = jax_ts.sgd_nesterov()
        state = jax_ts.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                  opt_state=tx.init(params), tx=tx, apply_fn=jmodel.apply)
        model = UNet(**config)
        model.load_state_dict(convert.params_from_jax(jax.device_get(params), model),
                              strict=True)
        torch.save(model.state_dict(), d / f"init_{name}.pt")
        models[name] = (jmodel, state, model)
    jmodel, state, model = models["tiny"]
    _write_cli_data(d)

    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = os.pathsep.join([str(REPO)] + [p for p in env.get(
        "PYTHONPATH", "").split(os.pathsep) if p])
    env["UNET_TPU_DECODE_CACHE"] = ""
    procs = _launch("--worker", WORLD, d, env) + _launch("--cli", CLI_WORLD, d, env)
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out[-4000:]}"
    return {"dir": d, "state": state, "batch": batch, "model": model, "jmodel": jmodel,
            "models": models}


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _ranks(sp_run, name: str) -> list:
    return [torch.load(sp_run["dir"] / f"{name}_rank{r}.pt") for r in range(WORLD)]


def _assembled(ranks: list, key: str, n_data: int) -> np.ndarray:
    """The global batch's output from the ranks' gathered data shards (each
    space rank gathered the same)."""
    by_data = {r["data_rank"]: r[key].numpy() for r in ranks}
    assert len(by_data) == n_data
    return np.concatenate([by_data[i] for i in range(n_data)])


@pytest.mark.parametrize("name", GRIDS)
def test_spatial_forward_matches_jax(sp_run, name):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from unet_implementations_tpu.parallel.spatial import (
        create_mesh_dp_sp,
        spatial_forward_jit,
        spatial_sharding,
    )

    n_data, n_space = GRIDS[name]
    ranks = _ranks(sp_run, name)
    for r in ranks[1:]:  # the space ranks of a data rank gathered the same rows
        if r["data_rank"] == ranks[0]["data_rank"]:
            assert torch.equal(r["logits"], ranks[0]["logits"])
    got = _assembled(ranks, "logits", n_data)
    state, jmodel = sp_run["state"], sp_run["jmodel"]
    x = jnp.asarray(sp_run["batch"]["x"])
    want = np.asarray(jmodel.apply({"params": state.params}, x, deterministic=True))
    assert _rel_l2(got, want) <= FWD_REL_L2, _rel_l2(got, want)

    mesh = create_mesh_dp_sp(n_space, n_data=n_data)
    jax_spatial = np.asarray(spatial_forward_jit(jmodel, mesh)(
        jax.device_put(state.params, NamedSharding(mesh, P())),
        jax.device_put(x, spatial_sharding(mesh))))
    assert float(np.abs(got - jax_spatial).max()) <= JAX_SPATIAL_TOL

    # The shards without the group: local statistics, zero rows at their
    # edges. They must miss the bound by far, or the test could not fail.
    alone = _assembled(ranks, "alone", n_data)
    assert _rel_l2(alone, want) > 100 * FWD_REL_L2, _rel_l2(alone, want)


@pytest.mark.parametrize("name", GRIDS)
def test_spatial_train_step_matches_jax_full_batch(sp_run, name):
    import jax
    import jax.numpy as jnp

    from unet_implementations_tpu.training import steps as jax_steps
    from unet_implementations_tpu_torch.models import convert

    state, model = sp_run["state"], sp_run["model"]
    jbatch = {k: jnp.asarray(sp_run["batch"][k]) for k in ("image", "mask")}
    want_state, want_loss = jax_steps.make_segmentation_train_step(donate=False)(
        state, jbatch, jax.random.key(0))
    want_loss = float(want_loss)
    want = convert.params_from_jax(jax.device_get(want_state.params), model)
    ranks = _ranks(sp_run, name)
    for rank, got in enumerate(ranks):
        assert abs(got["loss"] - want_loss) <= LOSS_REL * abs(want_loss), (rank, got["loss"],
                                                                          want_loss)
        for key, value in got["params"].items():
            assert _rel_l2(value.numpy(), want[key].numpy()) <= PARAM_REL_L2, (rank, key)
    # The mean of the shards' own losses (their own class weights, CE
    # denominators, statistics and Dice) must miss the global loss by far.
    own = float(np.mean([r["own_loss"] for r in ranks]))
    assert abs(own - want_loss) > 100 * LOSS_REL * abs(want_loss), (own, want_loss)


def _models_ranks(sp_run, name: str) -> list:
    n_data, n_space = GRIDS[name]
    return [torch.load(sp_run["dir"] / f"models_dp{n_data}_sp{n_space}_rank{r}.pt")
            for r in range(WORLD)]


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("name", GRIDS)
def test_spatial_models_match_jax(sp_run, name, model, monkeypatch):
    """The s2d model (fold off and on) and the k = 5 model on row shards
    against JAX's unsharded forward and its ``spatial_forward_jit``, JAX's
    policy set as the workers' was (JAX reads it while tracing)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from unet_implementations_tpu.parallel.spatial import (
        create_mesh_dp_sp,
        spatial_forward_jit,
        spatial_sharding,
    )

    n_data, n_space = GRIDS[name]
    monkeypatch.setenv(FOLD_VAR, "1" if MODELS[model][1] else "0")
    got = _assembled(_models_ranks(sp_run, name), model, n_data)
    jmodel, state, _ = sp_run["models"][model]
    x = jnp.asarray(sp_run["batch"]["x"])
    want = np.asarray(jax.jit(lambda p, x: jmodel.apply({"params": p}, x))(state.params, x))
    assert _rel_l2(got, want) <= FWD_REL_L2, _rel_l2(got, want)
    mesh = create_mesh_dp_sp(n_space, n_data=n_data)
    jax_spatial = np.asarray(spatial_forward_jit(jmodel, mesh)(
        jax.device_put(state.params, NamedSharding(mesh, P())),
        jax.device_put(x, spatial_sharding(mesh))))
    assert float(np.abs(got - jax_spatial).max()) <= JAX_SPATIAL_TOL


@pytest.fixture(scope="module")
def s2d_fold_step(sp_run):
    """JAX's unsharded step of the s2d model with the fold on: (loss, the
    updated parameters as the port's state dict)."""
    import jax
    import jax.numpy as jnp

    from unet_implementations_tpu.training import steps as jax_steps
    from unet_implementations_tpu_torch.models import convert

    _, state, model = sp_run["models"]["s2d_fold"]
    jbatch = {k: jnp.asarray(sp_run["batch"][k]) for k in ("image", "mask")}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(FOLD_VAR, "1")
        want_state, want_loss = jax_steps.make_segmentation_train_step(donate=False)(
            state, jbatch, jax.random.key(0))
    return float(want_loss), convert.params_from_jax(jax.device_get(want_state.params), model)


@pytest.mark.parametrize("name", GRIDS)
def test_spatial_s2d_fold_step_matches_jax_full_batch(sp_run, s2d_fold_step, name):
    want_loss, want = s2d_fold_step
    for rank, got in enumerate(_models_ranks(sp_run, name)):
        loss = got["s2d_fold loss"]
        assert abs(loss - want_loss) <= LOSS_REL * abs(want_loss), (rank, loss, want_loss)
        for key, value in got["s2d_fold params"].items():
            assert _rel_l2(value.numpy(), want[key].numpy()) <= PARAM_REL_L2, (rank, key)


def test_halo_backward_is_its_transpose_and_bad_grids_are_refused(sp_run):
    ranks = [torch.load(sp_run["dir"] / f"halo_rank{r}.pt") for r in range(WORLD)]
    forward = sum(r["forward"] for r in ranks)
    transpose = sum(r["transpose"] for r in ranks)
    assert abs(forward - transpose) <= 1e-5 * max(abs(forward), 1.0), (forward, transpose)
    for r in ranks:
        assert r["refused"] is not None and "does not divide" in r["refused"], r["refused"]


def _halo_rows_of(x, n_space, whole, halo):
    """``halo`` on each of n_space row shards of x, with the neighbours' edge
    rows (the shard's own at the edges), against ``whole`` of x."""
    h = x.shape[1] // n_space
    rows = []
    for s in range(n_space):
        shard = x[:, s * h:(s + 1) * h]
        above = x[:, s * h - 1:s * h] if s > 0 else shard[:, :1]
        below = x[:, (s + 1) * h:(s + 1) * h + 1] if s < n_space - 1 else shard[:, -1:]
        rows.append(halo(shard, above, below))
    return torch.cat(rows, dim=1), whole(x)


@pytest.mark.parametrize("n_space", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_halo_upsample_rows_are_the_unsharded_rows(n_space, dtype):
    x = torch.from_numpy(np.random.default_rng(43).normal(size=(2, 8, 6, 5))).to(dtype)
    got, want = _halo_rows_of(x, n_space, upsample2x_nhwc_fast, upsample2x_nhwc_halo)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n_space", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_halo_s2d_upsample_rows_are_the_unsharded_rows(n_space, dtype):
    x = torch.from_numpy(np.random.default_rng(44).normal(size=(2, 8, 6, 5))).to(dtype)
    got, want = _halo_rows_of(x, n_space, upsample2x_into_s2d_fast, upsample2x_into_s2d_halo)
    assert torch.equal(got, want)


def test_refusals_without_a_group(tmp_path):
    ctx = spatial.SpatialContext(group=None, size=4, index=0)
    x = torch.zeros(1, 6, SIZE, 3)  # 24 rows over 4 ranks: shards of 6, not divisible by 4
    with pytest.raises(ValueError, match="divisible by 4·4"):
        UNet(**TINY)(x, spatial=ctx)
    # k = 5 takes two halo rows a side: 16 rows over 4 ranks leave shards of
    # one row at the bottleneck (the s2d layout runs on shards too).
    with pytest.raises(ValueError, match="H must be at least 32"):
        UNet(**{**TINY, "s2d_level0": True, "kernel_size": 5})(torch.zeros(1, 4, SIZE, 3),
                                                               spatial=ctx)
    argv = ["our_unet", "train", "--data_dir", str(tmp_path / "none"), "--output_dir",
            str(tmp_path / "o"), "--device", "cpu", "--spatial", "2"]
    with pytest.raises(ValueError, match="--grad_accum with --spatial"):
        cli.main(argv + ["--grad_accum", "2"])
    with pytest.raises(ValueError, match="no_mesh"):
        cli.main(argv + ["--no_mesh"])
    assert not (tmp_path / "o").exists()


def test_cli_train_spatial_two_ranks(sp_run):
    from unet_implementations_tpu_torch.models import convert

    run = sp_run["dir"] / "run"
    lines = (run / "training_log.csv").read_text().splitlines()
    assert len(lines) == 2 and lines[1].startswith("1,"), lines
    assert json.loads((run / "training_config.json").read_text())["spatial"] == CLI_WORLD
    ranks = [torch.load(sp_run["dir"] / f"cli_rank{r}.pt") for r in range(CLI_WORLD)]
    # 2 training images at a global b2 on one space group: one step.
    assert [(r["step"], r["epochs_run"]) for r in ranks] == [(1, 1)] * CLI_WORLD
    params = ranks[0]["params"]
    for key, value in ranks[1]["params"].items():
        assert torch.equal(value, params[key]), key
    sd = torch.load(run / "best_model" / "model.pth", weights_only=True)["model_state_dict"]
    assert sd.keys() == params.keys()
    for key, value in sd.items():
        assert torch.equal(value, params[key]), key
    convert.load_reference_checkpoint(run / "best_model" / "model.pth", device="cpu",
                                      dtype=torch.float32)


def test_cli_predict_spatial_two_ranks(sp_run, tmp_path):
    import cv2

    from unet_implementations_tpu_torch.recipes.common import predict_segmentation

    d = sp_run["dir"]
    assert [json.loads((d / f"predict_rank{r}.json").read_text())
            for r in range(CLI_WORLD)] == [2] * CLI_WORLD
    n = predict_segmentation(d / "run" / "best_model" / "model.pth", d / "predict_in",
                             tmp_path, dtype=torch.float32, overlay=False, device="cpu",
                             verbose=False)
    assert n == 2
    for name in ("p0_mask.png", "p1_mask.png"):
        got = cv2.imread(str(d / "predict_sp" / name), cv2.IMREAD_GRAYSCALE)
        want = cv2.imread(str(tmp_path / name), cv2.IMREAD_GRAYSCALE)
        assert got.shape == want.shape
        assert np.array_equal(got, want), (name, int((got != want).sum()))


if __name__ == "__main__":
    modes = {"--worker": worker, "--cli": cli_worker}
    if sys.argv[1:2] == [] or sys.argv[1] not in modes:
        sys.exit("usage: test_torch_spatial.py --worker|--cli RANK PORT DIR")
    modes[sys.argv[1]](int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
