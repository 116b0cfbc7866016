"""Ahead-of-time export of the model's forward for serving (``torch.export``).

Counterpart of ``unet_implementations_tpu/serving/export.py``. A serving
host should replay the forward without the model's code: ``torch.export``
traces the eval forward at a static serving shape into a graph of ATen ops
and the port's kernel operators, and ``torch.export.save`` writes it with
the weights inside. Every kernel on the inference path is an operator
(``torch.ops.unet_torch``, registered by ``kernels/``), so the graph holds
one node per kernel launch: 22 K1 and 5 K2a in the dense 6-stage model; 16
K1, 3 K2a, 2 K2b and 3 K3 in the space-to-depth layout (``S2D_LAYOUT``).
Replayed on the card, those nodes launch the kernels; on the CPU, their plain
versions. Exported under the fp8 conv mode (``UNET_TPU_CONV_FP8``, read
while tracing), each quantized conv is a ``unet_torch::fp8_conv`` node.

Artifact layout (a directory):

    forward.pt2         ``torch.export.save`` of the exported forward (weights inside)
    export_meta.json    recipe, batch and image geometry, input dtype, device, versions

The artifact is exported on the device it serves (CUDA unless the caller
builds the model on the CPU) and ``load_exported`` refuses it on another
device: an exported program keeps the device of its tensors and of every op
that makes one. The loader imports the kernel modules, which register the
operators, and nothing of ``models/``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from unet_implementations_tpu_torch import default_device
from unet_implementations_tpu_torch.kernels import (  # noqa: F401
    fp8_conv,
    instance_norm,
    s2d_region,
    upsample,
)

ARTIFACT_FORWARD = "forward.pt2"
ARTIFACT_META = "export_meta.json"

# Recipes whose forward takes the image; clip_unet also takes the batch's
# CLIP embeddings.
_IMAGE_ONLY_RECIPES = ("our_unet", "ae_transfer", "ae_recon")
_RECIPES = _IMAGE_ONLY_RECIPES + ("clip_unet",)


def _build_recipe_model(recipe: str, dtype: torch.dtype, clip_dim: int, device=None):
    """The model a recipe trains, on ``device`` (CUDA unless named)."""
    from unet_implementations_tpu_torch.models.unet import autoencoder_6stage, unet_6stage

    if recipe in ("our_unet", "ae_transfer"):
        return unet_6stage(dtype=dtype, device=device)
    if recipe == "ae_recon":
        return autoencoder_6stage(dtype=dtype, device=device)
    if recipe == "clip_unet":
        return unet_6stage(dtype=dtype, device=device, clip_fusion=True, clip_dim=clip_dim)
    raise ValueError(f"unknown recipe {recipe!r}; expected one of {_RECIPES}")


def _device_of(module: torch.nn.Module) -> torch.device:
    device = next(module.parameters()).device
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def export_forward(
    model: torch.nn.Module,
    *,
    batch_size: int = 1,
    img_size: int = 512,
    clip_dim: Optional[int] = None,
    input_dtype: torch.dtype = torch.bfloat16,
) -> torch.export.ExportedProgram:
    """Export ``model``'s eval forward at a static (batch_size, img_size,
    img_size, 3) input of ``input_dtype`` on the model's device.

    ``clip_dim`` not None exports ``forward(image, clip_features)`` with
    (batch_size, clip_dim) features, the CLIP-fusion variant; otherwise
    ``forward(image)``. The model is traced in eval mode without autograd,
    so each kernel is its operator's node (``kernels/``); its mode is
    restored after."""
    device = _device_of(model)
    args = (torch.zeros((batch_size, img_size, img_size, 3), dtype=input_dtype, device=device),)
    if clip_dim is not None:
        args += (torch.zeros((batch_size, clip_dim), dtype=input_dtype, device=device),)
    training = model.training
    model.eval()
    try:
        with torch.no_grad():
            return torch.export.export(model, args)
    finally:
        model.train(training)


def _output_shape(program: torch.export.ExportedProgram) -> list:
    out = next(n for n in program.graph.nodes if n.op == "output").args[0][0]
    return [int(d) for d in out.meta["val"].shape]


def save_exported(
    output_dir: str | Path,
    model: torch.nn.Module,
    *,
    recipe: str = "our_unet",
    batch_size: int = 1,
    img_size: int = 512,
    clip_dim: Optional[int] = None,
    input_dtype: torch.dtype = torch.bfloat16,
) -> Path:
    """Export and write the self-contained serving artifact directory."""
    from torch._export.serde.schema import SCHEMA_VERSION

    output_dir = Path(output_dir).absolute()
    output_dir.mkdir(parents=True, exist_ok=True)
    program = export_forward(model, batch_size=batch_size, img_size=img_size,
                             clip_dim=clip_dim, input_dtype=input_dtype)
    program.example_inputs = None  # the zeros it was traced with: not saved
    torch.export.save(program, output_dir / ARTIFACT_FORWARD)
    meta = {
        "recipe": recipe,
        "batch_size": int(batch_size),
        "img_size": int(img_size),
        "clip_dim": None if clip_dim is None else int(clip_dim),
        "input_dtype": str(input_dtype).removeprefix("torch."),
        "device": str(_device_of(model)),
        "torch_version": torch.__version__,
        # The major version of torch.export's serialized schema.
        "calling_convention_version": int(SCHEMA_VERSION[0]),
        "output_shape": _output_shape(program),
    }
    (output_dir / ARTIFACT_META).write_text(json.dumps(meta, indent=4))
    return output_dir


def _without_metadata_asserts(module: torch.fx.GraphModule) -> torch.fx.GraphModule:
    """``module`` without its ``aten._assert_tensor_metadata`` nodes. Export
    puts one before every ``.to`` (48 in the dense 6-stage forward), asserting
    the dtype and device its tensor had when traced: inside the graph they
    hold by construction, and a ``.to`` of the input converts whatever dtype
    it is given. Each is a host-side call at every replay, which a request
    at batch 1, bound by the host's dispatch, pays for."""
    graph = module.graph
    for node in list(graph.nodes):
        if node.op == "call_function" and \
                node.target is torch.ops.aten._assert_tensor_metadata.default:
            graph.erase_node(node)
    module.recompile()
    return module


class ServingModel:
    """A loaded serving artifact. ``__call__`` is the exported call itself;
    ``forward`` and ``predict`` pad and chunk to the exported static batch,
    so callers can send any batch size (larger inputs in chunks)."""

    def __init__(self, program: torch.export.ExportedProgram, meta: Dict[str, Any]):
        self.program = program
        self.meta = meta
        self.batch_size = int(meta["batch_size"])
        self.input_dtype = getattr(torch, meta["input_dtype"])
        self.device = torch.device(meta["device"])
        self._module = _without_metadata_asserts(program.module())

    @torch.inference_mode()
    def __call__(self, image: torch.Tensor, clip_features: Optional[torch.Tensor] = None):
        """Raw exported call: shapes, dtypes and device must match the export."""
        if clip_features is None:
            return self._module(image)
        return self._module(image, clip_features)

    def _chunks(self, t, n: int):
        """``t`` on the device in the input dtype, as static-batch chunks, the
        last one padded with zeros."""
        t = torch.as_tensor(t).to(self.device, self.input_dtype)
        bs = self.batch_size
        for lo in range(0, n, bs):
            chunk = t[lo:lo + bs]
            pad = bs - chunk.shape[0]
            if pad:
                chunk = torch.cat([chunk, chunk.new_zeros((pad, *chunk.shape[1:]))])
            yield chunk, bs - pad

    @torch.inference_mode()
    def forward(self, image, clip_features=None) -> torch.Tensor:
        """The outputs of an arbitrary batch (numpy or tensor), through the
        static-batch program; a tensor on the artifact's device."""
        n = len(image)
        if n == 0:
            raise ValueError("predict() called with an empty batch")
        images = self._chunks(image, n)
        feats = self._chunks(clip_features, n) if clip_features is not None else None
        outs = []
        for chunk, real in images:
            out = self(chunk) if feats is None else self(chunk, next(feats)[0])
            outs.append(out[:real])
        return torch.cat(outs) if len(outs) > 1 else outs[0]

    def predict(self, image, clip_features=None) -> np.ndarray:
        """``forward`` of arbitrary-batch inputs, as a numpy array."""
        return self.forward(image, clip_features).cpu().numpy()


def load_exported(path: str | Path, device=None) -> ServingModel:
    """Load a ``save_exported`` artifact; no model code is needed. ``device``
    (default: CUDA) must be the one the artifact was exported on."""
    path = Path(path).absolute()
    meta = json.loads((path / ARTIFACT_META).read_text())
    want = default_device(device)
    if want.type == "cuda" and want.index is None:
        want = torch.device("cuda", torch.cuda.current_device())
    if want != torch.device(meta["device"]):
        raise ValueError(f"the artifact at {path} was exported on {meta['device']}; load it "
                         f"there, or export it again on {want}")
    return ServingModel(torch.export.load(path / ARTIFACT_FORWARD), meta)


def export_recipe_checkpoint(
    model_path: str | Path,
    output_dir: str | Path,
    *,
    recipe: str = "our_unet",
    batch_size: int = 1,
    img_size: int = 512,
    clip_dim: int = 512,
    dtype: torch.dtype = torch.bfloat16,
    device=None,
) -> Tuple[Path, Dict[str, Any]]:
    """CLI body: restore a training checkpoint (a directory or a reference
    ``.pth``) into the recipe's model on ``device`` and export it there."""
    from unet_implementations_tpu_torch.training.checkpoint import restore_params

    use_clip = recipe == "clip_unet"
    model = restore_params(model_path, _build_recipe_model(recipe, dtype, clip_dim, device))
    out = save_exported(output_dir, model, recipe=recipe, batch_size=batch_size,
                        img_size=img_size, clip_dim=clip_dim if use_clip else None,
                        input_dtype=dtype)
    return out, json.loads((out / ARTIFACT_META).read_text())
