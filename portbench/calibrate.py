#!/usr/bin/env python3
"""Readings that set the limits of ``correct``.

    python3 portbench/calibrate.py --workload NAME --mode MODE --seeds 1,2,3 [--seconds S]

Modes, each over the seeds in one process, one JSON line a seed:

- ``sound``: the cell's own run (a short window of ``--seconds``) and its
  comparison with the reference: the lower readings.
- ``control``: the same comparison with the nearest lower precision in the
  program's place. Training: the reference in fp8 (every conv's operands
  rounded to float8 e5m2, as the program's fp8 conv mode rounds them)
  against the reference in float32. Serving: the
  program's own fp8 conv mode (``UNET_TPU_CONV_FP8=all``) against the
  reference.
- ``half`` (training): the reference computing each step on half of the
  batch (the loss the mean over it) against the reference on all of it.
- ``unchanged`` (training): the reference whose steps leave the state
  unchanged (learning rate 0) against the reference.

The benchmark's own runs never run these.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))
os.environ["USE_FLAX"] = "0"

import torch  # noqa: E402

from pb import compare, diag, manifest, runner, weights  # noqa: E402
from pb.drivers import train as train_driver  # noqa: E402
from reference import unet as ref_unet  # noqa: E402


def train_reference_pair(cell, seed, device, precision="fp8", keep_rows=None, lr=None):
    cfg, tr = cell.config, cell.traffic
    ref_unet.set_exact_float32()
    params0 = weights.make(ref_unet.param_shapes(cfg), seed, 3, device)
    if tr.get("clip"):
        from reference import clip as ref_clip
        batches = ref_clip.reference_batches(cell, seed, device)
    else:
        batches = train_driver.reference_batches(cell, seed, cell.chips, device)
    ref = ref_unet.train_steps(cfg, params0, batches, cfg["optimizer"])
    hp = cfg["optimizer"] if lr is None else dict(cfg["optimizer"], lr=lr)
    other = ref_unet.train_steps(cfg, params0, batches, hp,
                                 precision="float32" if keep_rows or lr is not None else precision,
                                 keep_rows=keep_rows)
    return compare.train_numbers(other, ref, params0)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", required=True,
                   choices=("sound", "control", "half", "unchanged"))
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args()
    cell = manifest.cell(args.workload)
    device = torch.device("cuda", 0)
    diag.report("calibrate")
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.perf_counter()
        if args.mode == "sound" or (args.mode == "control"
                                    and cell.traffic["driver"] == "predict"):
            if args.mode == "control":
                os.environ["UNET_TPU_CONV_FP8"] = "all"
            raw = runner.drive(cell, seed, args.seconds, False, device, time.perf_counter())
            peak = raw["memory_peak_bytes"]
            metrics = runner.read_metrics(cell, raw, False, cell.chips)
            runner._free(device)
            numbers = runner.check(cell, raw, seed, device)
            row = {**{k: v for k, v in numbers.items() if k != "detail"},
                   "detail": numbers.get("detail"), "metrics": metrics, "peak": peak}
            os.environ.pop("UNET_TPU_CONV_FP8", None)
        elif args.mode == "control":
            row = train_reference_pair(cell, seed, device)
        elif args.mode == "half":
            row = train_reference_pair(cell, seed, device,
                                       keep_rows=cell.traffic["batch"] // 2)
        else:
            row = train_reference_pair(cell, seed, device, lr=0.0)
        row = {"workload": cell.name, "mode": args.mode, "seed": seed,
               "seconds": time.perf_counter() - t, **row}
        print(json.dumps(row, default=str), flush=True)
        runner._free(device)


if __name__ == "__main__":
    main()
