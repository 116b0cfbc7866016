"""Checkpoints with the reference's cadence and artifacts.

Counterpart of ``unet_implementations_tpu/training/checkpoint.py``, which
writes Orbax directories. A checkpoint here is a directory too
(``checkpoints/epoch_{N}/``, ``best_model/``) holding two files:

- ``model.pth``: the reference schema (``epoch``, ``model_state_dict`` as
  float32 CPU tensors, ``best_dice``, ``config``), the one the JAX package's
  ``cli export_torch`` writes, so it loads into the JAX package
  (``models/convert.py::load_torch_checkpoint``) and into the reference's own
  evaluator. Beside those it holds what a resume needs:
  ``optimizer_state_dict`` (the momentum buffers, on the CPU), ``step`` (the
  global optimizer step, which seeds dropout) and ``early_stopping``. It
  loads under ``torch.load(weights_only=True)``: ``config`` holds no dtype
  objects.
- ``meta.json``: ``epoch``, ``best_metric``, ``config``, ``early_stopping``,
  the JAX package's sidecar.

``restore_params`` also takes a bare reference ``.pth``. The learning rate
has no state: it is a function of the epoch.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

import torch
from torch import nn

MODEL_FILE = "model.pth"
META_FILE = "meta.json"


def _cpu(value):
    """``value`` with every tensor in it moved to the CPU."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    if isinstance(value, dict):
        return {k: _cpu(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_cpu(v) for v in value)
    return value


def model_file(path: str | Path) -> Path:
    """The ``.pth`` of a checkpoint directory, or ``path`` itself when it
    is a file."""
    path = Path(path)
    return path / MODEL_FILE if path.is_dir() else path


def save_checkpoint(
    path: str | Path,
    model: nn.Module,
    optimizer: Optional[torch.optim.Optimizer],
    epoch: int,
    best_metric: float,
    config: Optional[Dict] = None,
    early_stopping: Optional[Dict] = None,
    step: int = 0,
) -> None:
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    ckpt = {
        "epoch": int(epoch),
        "model_state_dict": {k: v.detach().to("cpu", torch.float32).contiguous()
                             for k, v in model.state_dict().items()},
        "best_dice": float(best_metric),
        "config": config or {},
        "step": int(step),
        "early_stopping": early_stopping,
    }
    if optimizer is not None:
        ckpt["optimizer_state_dict"] = _cpu(optimizer.state_dict())
    torch.save(ckpt, str(path / MODEL_FILE))
    meta = {"epoch": int(epoch), "best_metric": float(best_metric), "config": config or {}}
    if early_stopping is not None:
        meta["early_stopping"] = early_stopping
    (path / META_FILE).write_text(json.dumps(meta, indent=4))


def load_checkpoint(path: str | Path) -> Dict:
    """The checkpoint dict of a directory or a ``.pth`` (on the CPU)."""
    return torch.load(str(model_file(path)), map_location="cpu", weights_only=True)


def _state_dict(ckpt) -> Dict[str, torch.Tensor]:
    return ckpt.get("model_state_dict", ckpt) if isinstance(ckpt, dict) else ckpt


def restore_checkpoint(path: str | Path, model: nn.Module,
                       optimizer: Optional[torch.optim.Optimizer] = None) -> Dict:
    """Load the model (strictly) and the optimizer state in place; returns
    the meta: ``epoch``, ``best_metric``, ``config``, ``early_stopping`` and
    ``step``."""
    ckpt = load_checkpoint(path)
    model.load_state_dict(_state_dict(ckpt), strict=True)
    if optimizer is not None and "optimizer_state_dict" in ckpt:
        optimizer.load_state_dict(ckpt["optimizer_state_dict"])
    meta = read_meta(path)
    meta.setdefault("epoch", int(ckpt.get("epoch", 0)))
    meta.setdefault("best_metric", float(ckpt.get("best_dice", 0.0)))
    meta["step"] = int(ckpt.get("step", 0))
    return meta


def restore_params(path: str | Path, model: nn.Module) -> nn.Module:
    """Load only the weights of a checkpoint directory or a reference
    ``.pth`` (a full checkpoint dict or a bare state dict) into ``model`` (a
    ``UNet``), strictly, through ``UNet.load_reference_state_dict``; returns
    ``model``."""
    return model.load_reference_state_dict(_state_dict(load_checkpoint(path)))


def extract_encoder_params(checkpoint_path: str | Path, model: nn.Module,
                           n_stages: int = 6) -> nn.Module:
    """Copy the ``encoder_stages.{i}`` weights (i < ``n_stages``) of a
    checkpoint into ``model`` in place (the encoder-transfer contract); the
    shapes must match. Returns ``model``; freeze the stages with
    ``training.train_state.with_frozen``."""
    prefixes = tuple(f"encoder_stages.{i}." for i in range(n_stages))
    sd = _state_dict(load_checkpoint(checkpoint_path))
    encoder = {k: v for k, v in sd.items() if k.startswith(prefixes)}
    own = model.state_dict()
    missing = sorted(k for k in own if k.startswith(prefixes) and k not in encoder)
    if missing:
        raise KeyError(f"checkpoint lacks encoder weights: {missing[:4]}")
    for key, value in encoder.items():
        if own[key].shape != value.shape:
            raise ValueError(f"{key}: checkpoint {tuple(value.shape)}, "
                             f"model {tuple(own[key].shape)}")
    model.load_state_dict(encoder, strict=False)
    return model


def read_meta(path: str | Path) -> Dict:
    p = Path(path) / META_FILE
    return json.loads(p.read_text()) if p.exists() else {}
