"""Data parallelism: one process per GPU, each with its stripe of the batch.

Counterpart of ``unet_implementations_tpu/parallel/mesh.py``, in PyTorch's
idiom. JAX shards the batch over a 1-D device mesh, replicates the
parameters, and XLA inserts the gradient all-reduce into the unsharded
program, so the loss is the global batch's. Here:

- ``create_mesh()`` is the data-parallel context of the process group
  (``parallel/distributed.py``), or None when there is one process;
- ``wrap(model)`` (JAX's ``replicate``) wraps the model in
  ``DistributedDataParallel`` on its device, which broadcasts rank 0's
  parameters and averages the gradients after each backward;
- JAX's ``shard_batch`` becomes the loader's stripe: rank r reads the r-th
  of ``world_size`` equal contiguous shards of the training files
  (``PetDataset(process_index, process_count)``, ``stripe(mesh)``) in
  batches of ``mesh.local_batch(batch_size)`` rows. ``--batch_size`` stays the GLOBAL batch,
  as it is on a JAX host with several chips, so a run's optimization does not
  depend on how many cards share it.

Averaging the gradients of rank-local losses is not JAX's loss: the dynamic
class weights and the CE denominator would be each rank's own. The
segmentation loss therefore all-reduces both (``ops/losses.py``, ``group``)
and scales each rank's share so that the average is the global loss's
gradient; the train steps take the group from the wrapped model.

JAX's multi-host tail-batch truncation (``mesh.py:59-86``) has no
counterpart: training drops the last partial batch (every rank has the same
number of full batches), and validation is not striped (every rank runs the
whole validation set, so its metrics, and the early-stopping decision, are
the single-process ones).

Under spatial partitioning (``parallel/spatial.py::SpatialGrid``, a
``DataParallel`` on a (data, space) grid) the stripe and the local batch go
by the data rank alone: the ranks of one space group read the same images
and each keeps its rows of them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from unet_implementations_tpu_torch import default_device
from unet_implementations_tpu_torch.parallel import distributed

def _wrapped(model: nn.Module) -> bool:
    from unet_implementations_tpu_torch.parallel.spatial import SpatialParallel

    return isinstance(model, (DistributedDataParallel, SpatialParallel))


def unwrap(model: nn.Module) -> nn.Module:
    """The module inside a ``DistributedDataParallel`` or ``SpatialParallel``
    wrapper, else ``model``."""
    return model.module if _wrapped(model) else model


def process_group(model: nn.Module):
    """The process group a wrapped model reduces over, else None."""
    return model.process_group if _wrapped(model) else None


def wrap(model: nn.Module) -> DistributedDataParallel:
    """``model`` under ``DistributedDataParallel`` on its own device (JAX's
    ``replicate``): rank 0's parameters are broadcast to every rank at
    construction. Unused parameters are not searched for: every parameter
    that takes a gradient must take one in every step."""
    device = next(model.parameters()).device
    return DistributedDataParallel(
        model, device_ids=[device.index] if device.type == "cuda" else None)


@dataclass(frozen=True)
class DataParallel:
    """The data-parallel context of this process: its rank among
    ``world_size`` and the device its collectives run on."""

    rank: int
    world_size: int
    device: torch.device

    @property
    def data_rank(self) -> int:
        """This rank's shard of the batch (the rank, but on a spatial grid)."""
        return self.rank

    @property
    def n_data(self) -> int:
        """The shards of the batch (the world size, but on a spatial grid)."""
        return self.world_size

    def local_batch(self, batch_size: int) -> int:
        """This rank's images of a global batch of ``batch_size``."""
        if batch_size % self.n_data:
            raise ValueError(f"--batch_size {batch_size} does not divide into "
                             f"{self.n_data} ranks")
        return batch_size // self.n_data

    def check_agree(self, **flags: bool) -> None:
        """All-reduce boolean decisions (one collective) and raise unless
        every rank reached the same ones."""
        values = torch.tensor([float(v) for v in flags.values()], device=self.device)
        both = torch.cat([values, -values])
        dist.all_reduce(both, op=dist.ReduceOp.MAX)
        top, bottom = both[:len(flags)], -both[len(flags):]
        if not torch.equal(top, bottom):
            raise AssertionError(
                f"the ranks disagree: {dict(zip(flags, top.tolist()))} at most, "
                f"{dict(zip(flags, bottom.tolist()))} at least; rank {self.rank} has {flags}")


def create_mesh(device=None) -> Optional[DataParallel]:
    """The data-parallel context over the process group, with collectives on
    ``device`` (default: this rank's card), or None without a group or with
    one process."""
    if distributed.world_size() < 2:
        return None
    return DataParallel(distributed.rank(), distributed.world_size(), default_device(device))


def stripe(mesh: Optional[DataParallel]) -> Dict[str, int]:
    """The loader's keywords for this rank's shard of the training set (none
    without a mesh)."""
    if mesh is None:
        return {}
    return {"process_index": mesh.data_rank, "process_count": mesh.n_data}
