"""The training driver: a closed loop of the program's segmentation train
step (``training/steps.py::make_segmentation_train_step``), dispatched ahead
under a bounded run-ahead, on one card or as one rank of a data-parallel
group (``parallel/mesh.py::wrap``, DDP over NCCL).

Set-up builds the one step object (model, SGD-Nesterov state), loads the
harness's weights, stages the ring of input batches in pinned host memory,
and drives the step through its first three calls on three different
batches: they warm up every shape the window uses, and their losses, the
first gradient (the optimizer's momentum buffer after one step) and the
parameters after three steps are what the reference is held to. The same
object then runs the window. Each step draws its dropout from a generator
seeded from (seed, step, rank).

With ``clip`` in the traffic, each batch first goes through the program's
``recipes/common.py::wrap_online_augment_clip``: augmentation on the card,
the 224-pixel view, and the frozen ViT tower's features, which the fused
model's step takes (``use_clip``).
"""

from __future__ import annotations

import time
from contextlib import nullcontext
from typing import Callable, Dict, List, Optional

import torch

from pb import compare, data, weights
from pb.trace import TRACE_SECONDS, from_profile, profiler, span
from pb.window import RunAhead
from reference import unet as ref_unet

SETUP_STEPS = 3
RUN_AHEAD = 2

TRAFFIC_KEYS = ("batch", "ring", "clip")
# The model's keys, read by ``build_model``, the reference and the counts.
MODEL_KEYS = ("features_per_stage", "strides", "kernel_size", "in_channels", "num_classes",
              "n_conv_per_stage", "n_conv_per_stage_decoder", "encoder_dropout",
              "decoder_dropout", "image_size", "dtype", "param_dtype", "layout",
              "clip_fusion", "clip_dim", "clip_tower")
CONFIG_KEYS = MODEL_KEYS + ("optimizer",)
# The port's UNet takes RGB, keeps float32 parameters, and is built here in
# its dense layout: other values would run a model other than the one named.
FIXED = {"in_channels": 3, "param_dtype": "float32", "layout": "dense"}
OPTIMIZERS = ("sgd_nesterov",)


def step_generator(device, seed: int, step: int, rank: int) -> torch.Generator:
    return data.generator(device, seed, 100, step, rank)


def build_model(cfg: Dict, device: torch.device):
    from unet_implementations_tpu_torch.models.unet import UNet

    return UNet(num_classes=cfg["num_classes"], features_per_stage=cfg["features_per_stage"],
                strides=cfg["strides"], encoder_dropout_rates=cfg["encoder_dropout"],
                decoder_dropout_rates=cfg["decoder_dropout"], dtype=getattr(torch, cfg["dtype"]),
                kernel_size=cfg["kernel_size"], n_conv_per_stage=cfg["n_conv_per_stage"],
                n_conv_per_stage_decoder=cfg["n_conv_per_stage_decoder"],
                clip_fusion=cfg.get("clip_fusion", False),
                clip_dim=cfg.get("clip_dim", 512)).to(device)


class Feed:
    """Batch k of the run: the ring's batch k mod its length, through the
    online augmentation and the tower when the traffic asks for them."""

    def __init__(self, cell, seed: int, rank: int, device: torch.device):
        tr, cfg = cell.traffic, cell.config
        self.ring = data.ring(data.mix_seed(seed, rank), tr["ring"], tr["batch"],
                              cfg["image_size"], device, pinned=device.type == "cuda")
        self.clip = tr.get("clip", False)
        self.k = 0
        if self.clip:
            from unet_implementations_tpu_torch.models.clip import ClipFeatureExtractor
            from unet_implementations_tpu_torch.recipes.common import wrap_online_augment_clip
            from reference import clip as ref_clip

            tower = cfg["clip_tower"]
            self.extractor = ClipFeatureExtractor(tower["name"], dtype=getattr(torch, cfg["dtype"]),
                                                  device=device)
            self.extractor.model.load_state_dict(
                weights.make(ref_clip.param_shapes(tower), seed, 4, device), strict=True)
            self.it = wrap_online_augment_clip(self._raw(), 0, data.mix_seed(seed, 5) & 0x7FFFFFFF,
                                               device, self.extractor, rank=rank)

    def _raw(self):
        k = 0
        while True:
            yield self.ring[k % len(self.ring)]
            k += 1

    def next(self) -> Dict:
        if not self.clip:
            batch = self.ring[self.k % len(self.ring)]
        else:
            with span("batch_prep"):
                batch = next(self.it)
        self.k += 1
        return batch


def run(cell, seed: int, seconds: float, traced: bool, device: torch.device,
        t0: float, faults: Optional[Dict] = None, rank: int = 0, world: int = 1,
        control=None) -> Dict:
    """One run of a training cell on this process's device. Returns the
    timings, the program's first three steps and (with ``traced``) the
    trace; ``control`` is a gloo group whose rank 0 decides when the window
    ends (data parallelism). ``faults["step"]``, a test's, wraps the step."""
    from unet_implementations_tpu_torch.training.steps import make_segmentation_train_step
    from unet_implementations_tpu_torch.training.train_state import sgd_nesterov

    cfg, tr, hp = cell.config, cell.traffic, cell.config["optimizer"]
    if hp["name"] not in OPTIMIZERS:
        raise ValueError(f"optimizer {hp['name']!r}: the train driver runs {OPTIMIZERS}")
    wrap_step: Optional[Callable] = (faults or {}).get("step")
    model = build_model(cfg, device)
    params0 = weights.make(ref_unet.param_shapes(cfg), seed, 3, device)
    model.load_state_dict(params0, strict=True)
    names = [n for n, _ in model.named_parameters()]
    if world > 1:
        from unet_implementations_tpu_torch.parallel.mesh import wrap

        model = wrap(model)
    params = dict(zip(names, model.parameters()))
    opt = sgd_nesterov(model.parameters(), hp["lr"], hp["weight_decay"], hp["momentum"])
    step = make_segmentation_train_step(model, opt, weight_ce=hp["weight_ce"],
                                        weight_dice=hp["weight_dice"],
                                        use_clip=tr.get("clip", False))
    if wrap_step is not None:
        step = wrap_step(step, model=model, optimizer=opt)
    feed = Feed(cell, seed, rank, device)

    first: Dict = {"losses": []}
    losses = []
    for k in range(SETUP_STEPS):
        losses.append(step(feed.next(), step_generator(device, seed, k, rank)))
        if k == 0:
            first["grad1"] = {n: opt.state[p]["momentum_buffer"].detach().clone()
                              if "momentum_buffer" in opt.state.get(p, {})
                              else torch.zeros_like(p) for n, p in params.items()}
    first["params"] = {n: p.detach().clone() for n, p in params.items()}
    first["losses"] = [float(v) for v in losses]
    _sync(device)
    setup_s = time.perf_counter() - t0

    runahead = RunAhead(device, RUN_AHEAD)
    limit = min(seconds, TRACE_SECONDS) if traced else seconds
    dispatch: List[float] = []
    k = SETUP_STEPS
    prof = profiler(device) if traced else nullcontext()
    with prof:
        with span("window"):
            t_start = time.perf_counter()
            while True:
                batch = feed.next()
                gen = step_generator(device, seed, k, rank)
                t = time.perf_counter()
                step(batch, gen)
                dispatch.append(time.perf_counter() - t)
                runahead.push()
                k += 1
                if not _go_on(time.perf_counter() - t_start < limit, control):
                    break
            runahead.drain()
            _sync(device)
            t_end = time.perf_counter()
    out = {"setup_s": setup_s, "window_s": t_end - t_start, "steps": k - SETUP_STEPS,
           "forwards": k - SETUP_STEPS, "backward": True,
           "images": (k - SETUP_STEPS) * tr["batch"] * world, "dispatch_s": dispatch,
           "first": first, "params0": params0,
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else 0),
           "trace": from_profile(prof) if traced else None}
    del model, opt, step, feed, params, batch
    return out


def _go_on(mine: bool, control) -> bool:
    """Whether the window goes on: this process's clock alone, or rank 0's
    decision broadcast over the control group."""
    if control is None:
        return mine
    import torch.distributed as dist

    flag = torch.tensor([1 if mine else 0], dtype=torch.int32)
    dist.broadcast(flag, src=0, group=control)
    return bool(flag.item())


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reference_batches(cell, seed: int, world: int, device: torch.device) -> List[Dict]:
    """The first three steps' global batches and dropout keep masks, made
    again from the seed: every rank's ring batch k, rank after rank, and
    its keep masks from its own generator."""
    tr, cfg = cell.traffic, cell.config
    out = []
    rings = [data.ring(data.mix_seed(seed, r), SETUP_STEPS, tr["batch"], cfg["image_size"],
                       device, pinned=False) for r in range(world)]
    for k in range(SETUP_STEPS):
        keep = [ref_unet.draw_keep_masks(cfg, tr["batch"], step_generator(device, seed, k, r))
                for r in range(world)]
        out.append({"image": torch.cat([rings[r][k]["image"] for r in range(world)]),
                    "mask": torch.cat([rings[r][k]["mask"] for r in range(world)]),
                    "keep": [torch.cat(ms) for ms in zip(*keep)]})
    return out


def check(cell, raw: Dict, seed: int, device: torch.device, world: int = 1) -> Dict:
    """The reference's first three steps from the same weights and inputs,
    against the program's."""
    cfg, tr = cell.config, cell.traffic
    ref_unet.set_exact_float32()
    if tr.get("clip"):
        from reference import clip as ref_clip

        batches = ref_clip.reference_batches(cell, seed, device)
    else:
        batches = reference_batches(cell, seed, world, device)
    ref = ref_unet.train_steps(cfg, raw["params0"], batches, cfg["optimizer"])
    return compare.train_numbers(raw["first"], ref, raw["params0"])
