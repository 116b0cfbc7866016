"""The serving driver: one caller of the program's
``recipes/common.py::predict_arrays`` (upload, normalization, the forward,
the argmax read back, the nearest resize of each mask to its image's
original size on the host), each request a batch of 512-pixel uint8 images.

The loop is closed, as ``cli predict`` runs a folder of images: the caller
sends its next request when the last one's masks are on the host, for the
whole window. A request's latency runs from its call to its masks.

A sample of the finished requests, drawn from the seed (a reservoir of one)
and always holding the last, keeps its masks for the comparison with the
reference.
"""

from __future__ import annotations

import time
from contextlib import nullcontext
from typing import Dict, List

import numpy as np
import torch

from pb import compare, data, weights
from pb.drivers.train import CONFIG_KEYS, FIXED, build_model  # noqa: F401 (read by validate)
from pb.trace import TRACE_SECONDS, from_profile, profiler, span
from reference import unet as ref_unet

WARMUP_CALLS = 2
TRAFFIC_KEYS = ("batch", "ring", "sizes")


def run(cell, seed: int, seconds: float, traced: bool, device: torch.device,
        t0: float, faults=None, rank: int = 0, world: int = 1, control=None) -> Dict:
    """One run of a serving cell. ``faults["answer"]``, a test's, alters a
    request's masks where they are produced."""
    from unet_implementations_tpu_torch.recipes.common import predict_arrays

    cfg, tr = cell.config, cell.traffic
    answer_fault = (faults or {}).get("answer")
    model = build_model(cfg, device).eval()
    params0 = weights.make(ref_unet.param_shapes(cfg), seed, 3, device)
    model.load_state_dict(params0, strict=True)
    ring = [b["image"].cpu().numpy()
            for b in data.ring(seed, tr["ring"], tr["batch"], cfg["image_size"], device,
                               pinned=False)]
    sizes = [data.original_sizes(data.mix_seed(seed, i), tr["batch"], tr["sizes"])
             for i in range(tr["ring"])]
    for i in range(WARMUP_CALLS):
        predict_arrays(model, ring[i % len(ring)], sizes[i % len(ring)])
    _sync(device)
    setup_s = time.perf_counter() - t0

    limit = min(seconds, TRACE_SECONDS) if traced else seconds
    rng = np.random.default_rng(data.mix_seed(seed, 6))
    drawn, last = None, None
    latency: List[float] = []
    prof = profiler(device) if traced else nullcontext()
    with prof:
        with span("window"):
            t_start = time.perf_counter()
            while True:
                k = len(latency)
                slot = k % len(ring)
                begun = time.perf_counter()
                with span("request"):
                    masks = predict_arrays(model, ring[slot], sizes[slot])
                done = time.perf_counter()
                if answer_fault is not None:
                    masks = answer_fault(k, masks)
                latency.append(done - begun)
                # Reservoir sampling: request k replaces the drawn one with
                # probability 1 / (k + 1), so each finished request is as
                # likely to be drawn.
                if last is not None and rng.random() * k < 1.0:
                    drawn = last
                last = (k, masks)
                if done - t_start >= limit:
                    break
            _sync(device)
            t_end = time.perf_counter()
    memory = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del model
    kept = dict(x for x in (drawn, last) if x is not None)
    n = len(latency)
    return {"setup_s": setup_s, "window_s": t_end - t_start, "requests": n, "forwards": n,
            "backward": False, "failed": 0, "images": n * tr["batch"], "latency_s": latency,
            "kept": kept, "sizes": sizes, "params0": params0, "memory_peak_bytes": memory,
            "trace": from_profile(prof) if traced else None}


def check(cell, raw: Dict, seed: int, device: torch.device, world: int = 1) -> Dict:
    """The reference's logits of each kept request's images against its
    served masks."""
    cfg, tr = cell.config, cell.traffic
    ref_unet.set_exact_float32()
    gap, by_slot, counts = 0.0, {}, {}
    for k in sorted(raw["kept"]):
        slot = k % tr["ring"]
        if slot not in by_slot:
            pixels = data.ring(seed, slot + 1, tr["batch"], cfg["image_size"], device,
                               pinned=False)[slot]["image"]
            by_slot[slot] = ref_unet.predict_logits(cfg, raw["params0"], pixels)
        gap = max(gap, compare.mask_gap(raw["kept"][k], raw["sizes"][slot], by_slot[slot],
                                        counts))
    return {"mask_gap": gap, "detail": {"requests_compared": len(raw["kept"]), **counts}}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
