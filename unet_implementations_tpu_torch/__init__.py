"""unet_implementations_tpu_torch — the PyTorch/CUDA port for NVIDIA Hopper.

A second package beside the JAX reference ``unet_implementations_tpu``. It
keeps the reference's module names so each counterpart is easy to find:

- ``models``   — the 6-stage UNet as ``nn.Module``s, with the segmentation
                 or the reconstruction head (the autoencoder) and the CLIP
                 bottleneck fusion, the frozen CLIP ViT tower, the VGG16
                 feature extractor of the perceptual loss, and the
                 JAX-params / reference-``.pth`` converters.
- ``ops``      — pixel normalization, the bilinear resize primitives (the
                 plain versions the kernels are held to), the segmentation
                 and reconstruction losses and the metrics.
- ``kernels``  — hand-written CUDA C++ kernels for ``sm_90a`` (``csrc/``),
                 built with ``nvcc`` at first use and bound with ``ctypes``;
                 the differentiable ones carry their backward.
- ``training`` — optimizers, schedules, the segmentation and reconstruction
                 train and eval steps, the epoch loop, checkpoints and early
                 stopping.
- ``data``     — the dataset loader (segmentation and reconstruction modes,
                 the CLIP view) with its decode cache, the class-balanced
                 augmentation on the batch's device (``augment``), synthetic
                 batches and the CLIP view's padded copies (``pipeline``).
- ``recipes``  — the ``our_unet``, ``ae_recon``, ``ae_transfer`` and
                 ``clip_unet`` recipes (train, evaluate; CLIP embedding
                 tables; online augmentation), dataset evaluation and the
                 serving path (``predict_segmentation``).
- ``parallel`` — data parallelism: one process per GPU under
                 ``torch.distributed``, with the global batch's loss; and
                 spatial partitioning, each image's rows over the ranks of
                 a (data, space) grid.
- ``serving``  — the ``torch.export`` serving artifact.
- ``utils``    — the figures (``visualize``), Grad-CAM (``gradcam``), the
                 per-op cost table and kernel breakdown (``profiling``), the
                 dataset analyzer and helpers.
- ``cli``      — ``our_unet|ae_recon|ae_transfer train|evaluate``,
                 ``clip_unet train|evaluate|embed``, ``clip_resize``,
                 ``augment``, ``predict``, ``export``, ``convert``,
                 ``export_torch``, ``pipeline``, ``sanity_checks``,
                 ``download`` and ``profile``.

Public functions keep the JAX layout: NHWC in, NHWC float32 logits out.
Entry points run on CUDA unless the caller passes ``device="cpu"``; they never
fall back to the CPU on their own.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def default_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else CUDA:
    ``cuda:LOCAL_RANK`` under a process group (``parallel/distributed.py``),
    so each rank of a launch takes its own card, else ``cuda``.

    Raises when no device is given and no CUDA card is visible — the port
    never runs on the CPU unless the caller asked for it.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    from unet_implementations_tpu_torch.parallel import distributed

    if distributed.is_initialized():
        return torch.device("cuda", distributed.local_rank())
    return torch.device("cuda")


def not_ported(what: str, item: int) -> NotImplementedError:
    """The error of a JAX feature the port does not have yet: ``item`` is its
    entry in ROADMAP.md's queue 1."""
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet (ROADMAP.md queue 1 item {item})")
