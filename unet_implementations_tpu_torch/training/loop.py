"""Epoch-level orchestration: the reference trainers' contract, one loop.

Counterpart of ``unet_implementations_tpu/training/loop.py``. Per epoch: set
the epoch's learning rate, train an epoch, run a full validation pass,
append a CSV row, track the best model (mean foreground Dice for
segmentation, validation loss for reconstruction, from -inf / +inf), update
early stopping, then checkpoint every ``save_every`` epochs or on a new best.

It writes the JAX package's artifacts: ``training_log.csv`` with the
reference headers, ``checkpoints/epoch_{N}/`` and ``best_model/``
(``training/checkpoint.py``); ``write_training_config`` writes
``training_config.json``.

The model and its optimizer are updated in place by ``train_step(batch,
generator) -> loss``. Step ``n`` (the global optimizer step, kept in the
checkpoint) draws its dropout from a generator on the model's device seeded
from ``(dropout_seed, n)``, so a resumed run draws what an uninterrupted run
would have. Losses stay on the device: the host waits only for the step
``run_ahead`` steps back (env ``UNET_TPU_RUN_AHEAD``, default 4) and reads
the epoch's losses once. ``UNET_TPU_STEP_HEARTBEAT=N`` prints the timers
every N steps.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch
from torch import nn

from unet_implementations_tpu_torch.training.checkpoint import save_checkpoint
from unet_implementations_tpu_torch.training.early_stopping import EarlyStopping
from unet_implementations_tpu_torch.training.train_state import set_learning_rate

SEG_CSV_HEADER = (
    "epoch,train_loss,val_loss,dice_background,dice_cat,dice_dog,"
    "dice_mean_foreground,learning_rate,epoch_time"
)
AE_CSV_HEADER = "epoch,train_loss,val_loss,val_mse,val_psnr,learning_rate,epoch_time"
# Steps of the first epoch that ``profile_dir`` traces.
PROFILED_STEPS = 3


def write_training_config(output_dir: Path, config: Dict) -> None:
    output_dir.mkdir(parents=True, exist_ok=True)
    with open(output_dir / "training_config.json", "w") as f:
        json.dump(config, f, indent=4, default=str)


def dropout_generator(dropout_seed: int, step: int, device: torch.device) -> torch.Generator:
    """The generator of global step ``step``, seeded from ``(dropout_seed,
    step)`` mixed by numpy's ``SeedSequence`` (the CPU generator keeps only
    the low 32 bits of its seed, so both must reach them)."""
    mixed = np.random.SeedSequence([dropout_seed & 0xFFFFFFFF, step & 0xFFFFFFFF])
    return torch.Generator(device=device).manual_seed(int(mixed.generate_state(1, np.uint64)[0]))


class _Window:
    """Bounded run-ahead: marks each dispatched step on the device's stream
    and waits for the one ``depth`` steps back (a no-op on the CPU, where
    every op has finished when it returns)."""

    def __init__(self, device: torch.device, depth: int):
        self.cuda = device.type == "cuda"
        self.depth = depth
        self.marks: List = []

    def push(self) -> None:
        if self.cuda:
            event = torch.cuda.Event()
            event.record()
            self.marks.append(event)
            if len(self.marks) > self.depth:
                self.marks.pop(0).synchronize()

    def drain(self) -> None:
        for event in self.marks:
            event.synchronize()
        self.marks.clear()


def _profiler(device: torch.device):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=activities)


def _truncate_log(log_file: Path, header: str, start_epoch: int) -> None:
    """Resume: keep the header and the rows up to ``start_epoch``, so re-run
    epochs do not appear twice; malformed rows (a crash mid-write, a
    repeated header) are dropped instead of aborting the resume."""
    def keep(line: str) -> bool:
        try:
            return int(line.split(",", 1)[0]) <= start_epoch
        except ValueError:
            return False

    lines = log_file.read_text().splitlines()
    kept = [header] + [ln for ln in lines[1:] if ln.strip() and keep(ln)]
    log_file.write_text("\n".join(kept) + "\n")


def train_loop(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    *,
    train_step: Callable,
    eval_step: Callable,
    train_batches: Callable[[int], Iterable[Dict]],
    val_batches: Callable[[], Iterable[Dict]],
    lr_schedule: Callable[[int], float],
    epochs: int,
    output_dir: str | Path,
    task: str = "segmentation",
    dropout_seed: int = 0,
    step: int = 0,
    save_every: int = 10,
    patience: int = 15,
    start_epoch: int = 0,
    best_metric: Optional[float] = None,
    arch_config: Optional[Dict] = None,
    profile_dir: Optional[str | Path] = None,
    checkpoint_callback: Optional[Callable[[nn.Module, int], None]] = None,
    early_stopping_state: Optional[Dict] = None,
    verbose: bool = True,
) -> Dict[str, Any]:
    """Run the training loop from ``start_epoch`` (global step ``step``);
    returns ``{"best_metric", "epochs_run", "step", "epochs"}``, where
    ``epochs`` holds each epoch's timers: ``steps``, ``first_batch_s`` (from
    the epoch's start to its first batch, while the device has no work),
    ``data_s`` (waiting for the loader), ``step_s`` (dispatching steps and
    waiting on the window),
    ``train_s`` (the train phase's wall time, its final wait included),
    ``val_batches``, ``val_s`` and ``epoch_s``.

    ``train_batches(epoch)`` and ``val_batches()`` yield host numpy batch
    dicts; ``task`` selects the validation protocol and the CSV schema.
    """
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    device = next(model.parameters()).device

    monitor_mode = "max" if task == "segmentation" else "min"
    if best_metric is None:
        # -inf, not the reference's 0.0: a run whose metric never beats 0.0
        # must still write a best_model, or the evaluate flow dead-ends.
        best_metric = float("-inf") if monitor_mode == "max" else float("inf")
    early_stopping = EarlyStopping(
        patience=patience, mode=monitor_mode, verbose=verbose
    ).load_state_dict(early_stopping_state)

    log_file = output_dir / "training_log.csv"
    header = SEG_CSV_HEADER if task == "segmentation" else AE_CSV_HEADER
    if start_epoch == 0 or not log_file.exists():
        log_file.write_text(header + "\n")
    else:
        _truncate_log(log_file, header, start_epoch)

    run_ahead = int(os.environ.get("UNET_TPU_RUN_AHEAD", "4"))
    heartbeat = int(os.environ.get("UNET_TPU_STEP_HEARTBEAT", "0"))
    epochs_run = 0
    history = []

    for epoch in range(start_epoch, epochs):
        epoch_start = time.perf_counter()
        lr = lr_schedule(epoch)
        set_learning_rate(optimizer, lr)

        # --- train epoch ---------------------------------------------------
        losses = []
        data_time = step_time = 0.0
        window = _Window(device, run_ahead)
        prof = _profiler(device) if profile_dir is not None and epoch == start_epoch else None
        if prof is not None:
            prof.start()
        it = iter(train_batches(epoch))
        first_batch_s = None
        while True:
            t0 = time.perf_counter()
            batch = next(it, None)
            data_time += time.perf_counter() - t0
            if first_batch_s is None:
                first_batch_s = time.perf_counter() - epoch_start
            if batch is None:
                break
            t0 = time.perf_counter()
            losses.append(train_step(batch, dropout_generator(dropout_seed, step, device)))
            step += 1
            window.push()
            step_time += time.perf_counter() - t0
            if heartbeat and len(losses) % heartbeat == 0:
                print(f"    step {len(losses)}: data={data_time:.1f}s "
                      f"step={step_time:.1f}s", flush=True)
            if prof is not None and len(losses) >= PROFILED_STEPS:
                _finish_trace(prof, window, profile_dir)
                prof = None
        if prof is not None:
            _finish_trace(prof, window, profile_dir)
        # One transfer for the epoch's losses (it waits for the last step).
        train_loss = (float(np.mean(torch.stack(losses).cpu().numpy()))
                      if losses else 0.0)
        train_s = time.perf_counter() - epoch_start
        if verbose:
            print(f"  Data loading time: {data_time:.2f}s")
            print(f"  Train step time:   {step_time:.2f}s")

        # --- validation ----------------------------------------------------
        t0 = time.perf_counter()
        val = validate(eval_step, val_batches(), task)
        val_s = time.perf_counter() - t0
        epoch_time = time.perf_counter() - epoch_start

        if task == "segmentation":
            metric = val["dice_mean_foreground"]
            row = (
                f"{epoch + 1},{train_loss:.6f},{val['loss']:.6f},"
                f"{val['dice_background']:.6f},{val['dice_cat']:.6f},"
                f"{val['dice_dog']:.6f},{val['dice_mean_foreground']:.6f},"
                f"{lr:.7f},{epoch_time:.2f}"
            )
        else:
            metric = val["loss"]
            row = (
                f"{epoch + 1},{train_loss:.6f},{val['loss']:.6f},"
                f"{val['mse']:.6f},{val['psnr']:.4f},{lr:.7f},{epoch_time:.2f}"
            )
        with open(log_file, "a") as f:
            f.write(row + "\n")
        if verbose:
            print(f"Epoch {epoch + 1}/{epochs}: train={train_loss:.4f} "
                  f"val={val['loss']:.4f} metric={metric:.4f} lr={lr:.6f} "
                  f"({epoch_time:.1f}s)")
        history.append({"epoch": epoch + 1, "steps": len(losses),
                        "first_batch_s": first_batch_s, "data_s": data_time,
                        "step_s": step_time, "train_s": train_s,
                        "val_batches": val["batches"], "val_s": val_s, "epoch_s": epoch_time})

        is_best = metric > best_metric if monitor_mode == "max" else metric < best_metric
        if is_best:
            best_metric = metric

        # Update the patience counter BEFORE checkpointing, so the saved
        # state reflects this epoch and a resume stops where an
        # uninterrupted run would.
        stop = early_stopping(metric)

        if (epoch + 1) % save_every == 0 or is_best:
            dirs = [output_dir / "checkpoints" / f"epoch_{epoch + 1}"]
            if is_best:
                dirs.append(output_dir / "best_model")
            for d in dirs:
                save_checkpoint(d, model, optimizer, epoch + 1, best_metric, arch_config,
                                early_stopping=early_stopping.state_dict(), step=step)
            if checkpoint_callback is not None:
                checkpoint_callback(model, epoch + 1)

        epochs_run = epoch + 1
        if stop:
            if verbose:
                print(f"Early stopping triggered after {epoch + 1} epochs")
            break

    return {"best_metric": best_metric, "epochs_run": epochs_run, "step": step,
            "epochs": history}


def _finish_trace(prof, window: _Window, profile_dir: str | Path) -> None:
    """Stop the trace once the traced steps have run on the device, and
    write it as ``profile_dir/trace.json``."""
    window.drain()
    prof.stop()
    profile_dir = Path(profile_dir)
    profile_dir.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(profile_dir / "trace.json"))


def validate(eval_step: Callable, batches: Iterable[Dict],
             task: str = "segmentation") -> Dict[str, float]:
    """Full validation pass with the reference's batch-mean protocol.

    Segmentation: per-batch per-class hard Dice averaged over batches;
    reconstruction: mean loss, MSE and PSNR. The outputs stay on the device
    with the same bounded run-ahead as training and are read once at the
    end; ``batches`` in the result counts the batches."""
    outs = []
    window = None
    for batch in batches:
        out = eval_step(batch)
        if task == "segmentation":
            row = [out["loss"].reshape(1), out["dice"].reshape(-1)]
        else:
            row = [out["loss"].reshape(1), out["mse"].mean().reshape(1),
                   out["psnr"].mean().reshape(1)]
        outs.append(torch.cat([v.float() for v in row]))
        if window is None:
            window = _Window(out["loss"].device, 4)
        window.push()
    if not outs:
        if task == "segmentation":
            return {"loss": 0.0, "dice_background": 0.0, "dice_cat": 0.0, "dice_dog": 0.0,
                    "dice_mean_foreground": 0.0, "batches": 0}
        return {"loss": 0.0, "mse": 0.0, "psnr": 0.0, "batches": 0}
    host = torch.stack(outs).cpu().numpy()  # (batches, columns): one transfer
    loss = float(np.mean(host[:, 0]))
    if task == "segmentation":
        dice = np.mean(host[:, 1:4], axis=0)
        return {
            "loss": loss,
            "dice_background": float(dice[0]),
            "dice_cat": float(dice[1]),
            "dice_dog": float(dice[2]),
            "dice_mean_foreground": float((dice[1] + dice[2]) / 2),
            "batches": len(outs),
        }
    return {"loss": loss, "mse": float(np.mean(host[:, 1])), "psnr": float(np.mean(host[:, 2])),
            "batches": len(outs)}
