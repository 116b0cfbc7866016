"""Serving: the exported forward (``torch.export``) and its loader."""

from unet_implementations_tpu_torch.serving.export import (
    ServingModel,
    export_forward,
    load_exported,
    save_exported,
)

__all__ = [
    "ServingModel",
    "export_forward",
    "load_exported",
    "save_exported",
]
