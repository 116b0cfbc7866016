"""Spatial partitioning: each image's rows sharded over the ranks of a
(data, space) grid of processes, one process per GPU.

Counterpart of ``unet_implementations_tpu/parallel/spatial.py``. JAX
annotates the input's sharding and XLA's SPMD partitioner inserts the halo
exchanges and the InstanceNorm all-reduces. PyTorch has no partitioner, so
the port writes them out:

- ``create_mesh_dp_sp(n_space, n_data=None)`` lays the process group's ranks
  on a (data, space) grid. A space group is a run of ``n_space`` consecutive
  ranks, so on one node a group's neighbours are NVLink peers. The ranks of
  a space group read the same images; the loader's stripe and the local
  batch go by the data rank (``parallel/mesh.py``).
- ``shard_rows`` keeps this rank's rows of ``image`` and ``mask`` (JAX's
  ``shard_batch_spatial``): rank s of a space group of S holds rows
  ``[s·H/S, (s+1)·H/S)`` of every image.
- The model runs on the shard with a ``SpatialContext``
  (``UNet.forward(..., spatial=)``), in the dense and the s2d layout: each
  conv pads its input with halo rows from its neighbours (zero rows at the
  image's top and bottom): k//2 a side for a stride-1 k×k conv; at stride 2,
  whose even shard's last output row reads fewer rows below, k//2 above and
  k − 2 − k//2 below; one s2d row a side for an s2d 3×3 or 5×5 conv and the
  row above for the stride-2 conv of an s2d input. K1's statistics and
  K1bwd's sums are all-reduced over the space group between their passes
  (``kernels/instance_norm.py``; with ``group=4`` on s2d shards), and K2a
  and K2b run on rows with one halo row a side (``kernels/upsample.py``). A
  folded upsample (``ops/s2d.py::conv_up_fold``) runs on the shard with one
  neighbour row beyond each inner edge. K3 does not run on a shard (its
  statistics and conv span the tensor it is given), so an s2d block takes
  its module path there. The loss sums Dice's per-image sums over the space
  group and its class counts over the grid (``ops/losses.py``).
- ``SpatialParallel`` wraps a model for training: rank 0's parameters are
  broadcast when it is built, and after each backward the gradients are
  summed over the grid and divided by its size (``average_gradients``).
- ``spatial_forward`` and ``spatial_train_step`` (JAX's
  ``spatial_forward_jit`` and ``spatial_train_step_jit``).

Every collective is an all-reduce, which NCCL and gloo both take on CUDA
tensors. Two ranks on one card must speak gloo (NCCL refuses them), and gloo
takes no CUDA tensor in a point-to-point send. So a halo exchange is one
all-reduce of a float32 buffer with a slot per rank of the space group, each
rank filling its own slot with its edge rows: ``n_space`` times the bytes of
a send to each neighbour, for rows that are a small share of the activation
they pad. Gloo stages CUDA tensors through the host; that is the transport,
and the kernels run all the same.

The gradient. Each rank's loss is its share of the global batch's: the mean
of the ranks' losses is the global loss. The backward of every collective is
its transpose (a halo row's cotangent is added to the row it came from, on
its owner; an all-reduce's cotangent is all-reduced), so each rank's
backward gives the gradient of the sum of the ranks' losses through its own
uses of the parameters. Their sum over the grid, divided by its size, is the
gradient of the global loss: summed over space, averaged over data, the
step of JAX's unsharded program on the global batch. It is one all-reduce
after the backward, not ``DistributedDataParallel``, whose bucket
all-reduces would run during the backward, interleaved with the backward's
own collectives on the space groups.

Refused, each with a ValueError: a process group whose size ``n_space`` does
not divide, images whose height does not split into equal, even shards at
every level of the model (``UNet.forward``: H divisible by
``2^(stages-1) · n_space``; JAX's forward instead replicates an indivisible
axis), and shards too shallow for a conv's halo: a k×k conv takes its k//2
halo rows from the neighbouring ranks alone, so each level's shard must hold
k//2 rows (JAX's partitioner takes rows from further ranks).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from unet_implementations_tpu_torch import default_device
from unet_implementations_tpu_torch.parallel import distributed
from unet_implementations_tpu_torch.parallel.mesh import DataParallel

# The batch keys whose axis 1 is the image's rows.
ROW_KEYS = ("image", "mask")


@dataclass(frozen=True)
class SpatialContext:
    """What a forward on a row shard needs: the space group, its size, and
    this rank's place in it (rows ``[index·h, (index + 1)·h)`` of each image,
    h = H / size)."""

    group: object
    size: int
    index: int

    @property
    def first(self) -> bool:
        """Whether this shard holds the images' top row."""
        return self.index == 0

    @property
    def last(self) -> bool:
        """Whether this shard holds the images' bottom row."""
        return self.index == self.size - 1


@dataclass(frozen=True)
class SpatialGrid(DataParallel):
    """The (data, space) grid over the process group: rank ``r`` is space
    rank ``r % n_space`` of data rank ``r // n_space``. ``rank`` and
    ``world_size`` are the group's; ``context`` is this rank's space group."""

    n_space: int = 1
    context: Optional[SpatialContext] = None

    @property
    def data_rank(self) -> int:
        return self.rank // self.n_space

    @property
    def n_data(self) -> int:
        return self.world_size // self.n_space


def create_mesh_dp_sp(n_space: int, n_data: Optional[int] = None, device=None) -> SpatialGrid:
    """The (data, space) grid of the process group, with collectives on
    ``device`` (default: this rank's card). Every rank must call it (it
    creates every space group). ``n_data`` defaults to the world size over
    ``n_space``; the grid must hold every rank."""
    if n_space < 1:
        raise ValueError(f"n_space must be >= 1, got {n_space}")
    if not distributed.is_initialized():
        raise ValueError(
            f"spatial partitioning over {n_space} ranks needs a process group: launch with "
            f"python -m torch.distributed.run --nproc_per_node {n_space} (or a multiple); this "
            f"process has none")
    world, rank = distributed.world_size(), distributed.rank()
    if world % n_space:
        raise ValueError(f"a process group of {world} ranks does not divide into space groups "
                         f"of {n_space}")
    if n_data is None:
        n_data = world // n_space
    if n_data * n_space != world:
        raise ValueError(f"a (data {n_data}, space {n_space}) grid must hold all {world} ranks")
    groups = [dist.new_group(list(range(d * n_space, (d + 1) * n_space))) for d in range(n_data)]
    context = SpatialContext(groups[rank // n_space], n_space, rank % n_space)
    return SpatialGrid(rank, world, default_device(device), n_space, context)


def rows_of(t, context: SpatialContext):
    """This rank's rows (axis 1) of ``t``, a tensor or an array."""
    h = t.shape[1]
    if h % context.size:
        raise ValueError(f"{h} image rows do not split into {context.size} equal shards")
    step = h // context.size
    return t[:, context.index * step:(context.index + 1) * step]


def shard_rows(batch: Dict, context: SpatialContext) -> Dict:
    """``batch`` with this rank's rows of ``image`` and ``mask``; the other
    keys (``clip_features``, file names) stay as they are, per data rank."""
    return {k: rows_of(v, context) if k in ROW_KEYS and v is not None else v
            for k, v in batch.items()}


def _slots(local: torch.Tensor, context: SpatialContext) -> torch.Tensor:
    """(size, *local.shape) float32 whose slot s holds rank s's ``local``:
    one all-reduce of a zero buffer in which each rank fills its own slot (a
    sum with zeros, so every value arrives exact)."""
    buf = local.new_zeros((context.size, *local.shape), dtype=torch.float32)
    buf[context.index] = local
    dist.all_reduce(buf, group=context.group)
    return buf


class _HaloRows(torch.autograd.Function):
    """(above, below), each (B, n, W, C), of a row shard x (B, h, W, C): the
    last n rows of the rank above and the first n rows of the rank below,
    zero rows at the images' top and bottom. The backward is the transpose:
    each halo row's cotangent is added to the row it was copied from, on the
    rank that owns it."""

    @staticmethod
    def forward(ctx, x, context, n):
        ctx.context, ctx.shape, ctx.dtype, ctx.device, ctx.n = (context, x.shape, x.dtype,
                                                                x.device, n)
        slots = _slots(torch.stack([x[:, :n], x[:, -n:]]), context).to(x.dtype)
        zero = torch.zeros_like(x[:, :n])
        above = zero if context.first else slots[context.index - 1, 1]
        below = zero if context.last else slots[context.index + 1, 0]
        return above, below

    @staticmethod
    def backward(ctx, g_above, g_below):
        context, n = ctx.context, ctx.n
        b, _, w, c = ctx.shape
        zero = torch.zeros((b, n, w, c), dtype=ctx.dtype, device=ctx.device)
        g_above = zero if g_above is None else g_above
        g_below = zero if g_below is None else g_below
        # Slot s holds rank s's cotangents of the rank above's last rows and
        # the rank below's first rows.
        slots = _slots(torch.stack([g_above, g_below]), context).to(ctx.dtype)
        dx = torch.zeros(ctx.shape, dtype=ctx.dtype, device=ctx.device)
        if not context.first:
            dx[:, :n] += slots[context.index - 1, 1]
        if not context.last:
            dx[:, -n:] += slots[context.index + 1, 0]
        return dx, None, None


def halo_rows(x: torch.Tensor, context: SpatialContext, repeat_edges: bool = False,
              n: int = 1):
    """(above, below), each (B, n, W, C), of the row shard x (B, h, W, C):
    the n rows beyond it on each side, from the neighbouring ranks, which
    must hold n rows each. At the images' top and bottom they are zero rows
    (a conv's SAME padding), or with ``repeat_edges`` (n = 1) the shard's own
    edge rows (a resize's edge clamp)."""
    if not 1 <= n <= x.shape[1]:
        raise ValueError(f"a halo of {n} rows from shards of {x.shape[1]} rows: each level's "
                         f"shard must hold the rows its convs read beyond it")
    above, below = _HaloRows.apply(x, context, n)
    if repeat_edges and context.first:
        above = x[:, :1]
    if repeat_edges and context.last:
        below = x[:, -1:]
    return above, below


def pad_rows(x: torch.Tensor, context: SpatialContext, above: int = 1,
             below: int = 1) -> torch.Tensor:
    """The row shard x (B, h, W, C) with ``above`` halo rows above it and
    ``below`` below it (zero rows at the images' edges)."""
    n = max(above, below)
    if n == 0:
        return x
    up, down = halo_rows(x, context, n=n)
    return torch.cat([up[:, n - above:], x, down[:, :below]], dim=1)


def neighbour_rows(x: torch.Tensor, context: SpatialContext) -> torch.Tensor:
    """The row shard x (B, h, W, C) with one neighbour's row beyond each edge
    that is not an image's edge (an up-fold's input, ``ops/s2d.py::
    conv_up_fold``)."""
    up, down = halo_rows(x, context)
    return torch.cat(([] if context.first else [up]) + [x] + ([] if context.last else [down]),
                     dim=1)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over the ranks of ``group``, differentiably: the
    cotangent is summed over the ranks too (the transpose of the sum)."""
    return _AllReduceSum.apply(t, group)


def gather_rows(t: torch.Tensor, context: SpatialContext) -> torch.Tensor:
    """The whole images from every rank's row shard ``t`` (B, h, ...), on
    every rank of the space group: (B, h·size, ...) in ``t``'s dtype (its
    values carried in float32, so integers up to 2^24 and float32 values
    arrive exact)."""
    slots = _slots(t, context).to(t.dtype)
    return torch.cat(list(slots.unbind(0)), dim=1)


class SpatialParallel(nn.Module):
    """``module`` trained on row shards over ``grid``: its forward takes a
    shard and runs ``module(x, spatial=grid.context, ...)``. Rank 0's
    parameters are broadcast to every rank when it is built (as
    ``DistributedDataParallel`` does); ``average_gradients`` follows each
    backward. ``process_group`` is the grid's (the whole process group), over
    which the loss reduces its class counts."""

    def __init__(self, module: nn.Module, grid: SpatialGrid):
        super().__init__()
        self.module = module
        self.grid = grid
        self.process_group = dist.group.WORLD
        params = list(module.parameters())
        with torch.no_grad():
            flat = torch.cat([p.reshape(-1) for p in params])
            dist.broadcast(flat, src=0)
            _scatter(flat, params, lambda p, v: p.copy_(v))

    def forward(self, x: torch.Tensor, **kwargs):
        return self.module(x, spatial=self.grid.context, **kwargs)

    def average_gradients(self) -> None:
        """Each gradient summed over the grid's ranks and divided by their
        number, in one all-reduce. A parameter without a gradient (the same
        on every rank) is left without one."""
        params = [p for p in self.module.parameters() if p.grad is not None]
        if not params:
            return
        flat = torch.cat([p.grad.reshape(-1) for p in params])
        dist.all_reduce(flat)
        flat /= self.grid.world_size
        _scatter(flat, params, lambda p, v: p.grad.copy_(v))


def _scatter(flat: torch.Tensor, params: list, put: Callable) -> None:
    """``put(p, values)`` for each parameter, with its slice of ``flat``
    shaped as it is."""
    offset = 0
    for p in params:
        put(p, flat[offset:offset + p.numel()].view(p.shape))
        offset += p.numel()


def grid_of(model: nn.Module) -> Optional[SpatialGrid]:
    """The grid a ``SpatialParallel`` model trains over, else None."""
    return model.grid if isinstance(model, SpatialParallel) else None


@torch.no_grad()
def spatial_forward(model: nn.Module, grid: SpatialGrid, image: torch.Tensor,
                    **kwargs) -> torch.Tensor:
    """The deterministic forward of this rank's rows of ``image`` (B, H, W, 3,
    the whole images, the same on every rank of a space group): this rank's
    rows of the output (JAX's ``spatial_forward_jit``). Puts ``model`` in
    eval mode."""
    model.eval()
    return model(rows_of(image, grid.context), spatial=grid.context, **kwargs)


def spatial_train_step(model: nn.Module, optimizer: torch.optim.Optimizer, grid: SpatialGrid,
                       **loss_kwargs) -> Callable:
    """JAX's ``spatial_train_step_jit``: ``step(batch, generator) -> loss``,
    the segmentation train step of ``model`` wrapped in ``SpatialParallel``.
    ``batch`` holds the data rank's whole images (the same on every rank of a
    space group); the step keeps this rank's rows. ``generator`` must draw
    the same dropout masks on every rank of a space group. ``loss_kwargs``
    go to ``training.steps.make_segmentation_loss_fn``."""
    from unet_implementations_tpu_torch.training.steps import make_segmentation_train_step

    return make_segmentation_train_step(SpatialParallel(model, grid), optimizer, **loss_kwargs)
