"""The process group: one process per GPU under ``torch.distributed``.

Counterpart of ``unet_implementations_tpu/parallel/distributed.py``, which
wires ``jax.distributed`` for several hosts. Here every GPU has its own
process, started by a launcher such as ``torchrun``::

    python -m torch.distributed.run --nproc_per_node N \\
        -m unet_implementations_tpu_torch.cli our_unet train ...

``maybe_initialize_distributed`` joins the process group from explicit
arguments or from the launcher's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``). It is a no-op for a single
process started without that environment. Unlike JAX's, which prints and
carries on as one process when initialization fails, it raises: a launch of
N processes that quietly trained N unsynchronized models would be a
different run, not a degraded one.

``rank()``, ``world_size()``, ``local_rank()`` and ``is_primary()`` read the
group, and return 0, 1, 0 and True when there is none.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def maybe_initialize_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    device=None,
    timeout_s: Optional[float] = None,
) -> bool:
    """Join the process group; returns True when one exists (already or
    now), False for a single process with nothing to join.

    Explicit arguments win over the environment: ``init_method`` (e.g.
    ``tcp://localhost:29500``; else ``env://`` from ``MASTER_ADDR`` and
    ``MASTER_PORT``), ``world_size`` and ``rank`` (else ``WORLD_SIZE`` and
    ``RANK``), ``device`` (a card without an index, or none, is
    ``cuda:LOCAL_RANK``, else ``cuda:rank``).
    ``backend`` defaults to NCCL, or to gloo when ``device`` is the CPU. On a
    card, the process's current card is set to ``device``, which is then the
    card ``local_rank()`` names. Raises RuntimeError when initialization
    fails."""
    if is_initialized():
        return True
    env = {k: os.environ.get(k) for k in _ENV}
    if init_method is None and world_size is None and env["WORLD_SIZE"] is None:
        return False
    world_size = world_size if world_size is not None else int(env["WORLD_SIZE"] or 1)
    rank = rank if rank is not None else int(env["RANK"] or 0)
    init_method = init_method or "env://"
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(env["LOCAL_RANK"] or rank))
    backend = backend or ("gloo" if device.type == "cpu" else "nccl")
    kwargs = {}
    if timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout_s)
    try:
        if not dist.is_available():
            raise RuntimeError("this torch build has no torch.distributed")
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                                rank=rank, **kwargs)
    except Exception as e:
        raise RuntimeError(
            f"torch.distributed initialization failed (backend {backend}, {init_method}, "
            f"rank {rank} of {world_size}): {e}") from e
    return True


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def local_rank() -> int:
    """This process's card among its host's: ``LOCAL_RANK`` (as the launcher
    sets it), else the card the process group was joined on, else 0."""
    if os.environ.get("LOCAL_RANK") is not None:
        return int(os.environ["LOCAL_RANK"])
    if is_initialized() and torch.cuda.is_available():
        return torch.cuda.current_device()
    return 0


def is_primary() -> bool:
    """Whether this process writes the run's files: rank 0, or the only
    process."""
    return rank() == 0


def barrier() -> None:
    """Wait for every process of the group (a no-op without one)."""
    if is_initialized():
        dist.barrier()


def shutdown() -> None:
    """Leave the process group, if there is one."""
    if is_initialized():
        dist.destroy_process_group()
