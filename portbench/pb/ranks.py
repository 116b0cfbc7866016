"""Cells on several cards: one process a card, joined over NCCL.

``launch`` (in the process that prints the result, which touches no card)
starts ``run.py --rank r`` for each card and waits for all of them. Each
rank (``worker``) takes card r, joins the group, and runs the cell's driver
as one data-parallel rank; a gloo group carries rank 0's decision of when
the window ends and the ranks' summaries. Rank 0 then compares the averaged
update with the reference's step on the global batch and writes the result
for ``launch`` to print. Every rank looks for JAX and the JAX package in its
own modules once the window has closed (and rank 0 again once the reference
has run): where any rank finds one, every rank exits with code 3 and no
result is written.
"""

from __future__ import annotations

import json
import os
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

RUN_LIMIT_S = 340.0


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(cell, args, run_py: Path, started: float) -> Optional[Dict]:
    """Start the ranks and wait for them; ``started`` is this process's
    start on the wall clock, from which each rank counts its set-up. The
    program's kernels are built here first, once, rather than by every
    rank at its first launch into the one build directory."""
    from unet_implementations_tpu_torch.kernels import _build

    _build.build()
    out_dir = Path(tempfile.mkdtemp(prefix="portbench_ranks_"))
    port = _free_port()
    procs = []
    try:
        for r in range(cell.chips):
            env = dict(os.environ, LOCAL_RANK=str(r), RANK=str(r),
                       WORLD_SIZE=str(cell.chips))
            procs.append(subprocess.Popen(
                [sys.executable, str(run_py), "--workload", cell.name, "--seed", str(args.seed),
                 "--seconds", str(args.seconds), "--trace", str(args.trace), "--rank", str(r),
                 "--port", str(port), "--out", str(out_dir), "--started", repr(started)],
                stdout=sys.stderr, stderr=sys.stderr, env=env))
        deadline = time.monotonic() + RUN_LIMIT_S
        codes = []
        for p in procs:
            try:
                codes.append(p.wait(timeout=max(1.0, deadline - time.monotonic())))
            except subprocess.TimeoutExpired:
                codes.append(None)
                break
        if any(c != 0 for c in codes) or len(codes) < len(procs):
            print(f"[portbench] rank exit codes {codes}", file=sys.stderr)
            return None
        with open(out_dir / "result.json") as f:
            return json.load(f)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        shutil.rmtree(out_dir, ignore_errors=True)


def worker(cell, args, t0: float, faults: Optional[Dict] = None) -> int:
    """One rank: card ``args.rank`` over NCCL (on a machine without cards,
    the CPU over gloo, which tests use)."""
    import torch
    import torch.distributed as dist

    from pb import guard, runner

    rank, world = args.rank, cell.chips
    init = {"init_method": f"tcp://127.0.0.1:{args.port}", "rank": rank, "world_size": world}
    if torch.cuda.is_available():
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
        dist.init_process_group("nccl", device_id=device, **init)
    else:
        device = torch.device("cpu")
        dist.init_process_group("gloo", **init)
    control = dist.new_group(backend="gloo")
    try:
        traced = bool(args.trace)
        raw = runner.drive(cell, args.seed, args.seconds, traced, device, t0, faults,
                           rank=rank, world=world, control=control)
        mine = {"metrics": runner.read_metrics(cell, raw, traced, world),
                "memory_peak_bytes": raw["memory_peak_bytes"], "setup_s": raw["setup_s"],
                "forbidden": sorted(guard.loaded_forbidden())}
        if traced:
            mine.update(busy_s=raw["trace"].busy_s(), window_s=raw["trace"].window_s)
        every = [None] * world
        dist.all_gather_object(every, mine, group=control)
        found = {r: e["forbidden"] for r, e in enumerate(every) if e["forbidden"]}
        if found:
            print(f"[portbench] forbidden modules loaded, by rank: {found}", file=sys.stderr)
            return 3
        if rank != 0:
            return 0
        metrics = _merge(cell, every, traced, mine)
        block = runner.device_info(raw, world, device, traced,
                                   busy=statistics.fmean(e["busy_s"] for e in every)
                                   if traced else None,
                                   window=statistics.fmean(e["window_s"] for e in every)
                                   if traced else None)
        block["memory_peak_bytes"] = int(max(e["memory_peak_bytes"] for e in every))
        runner._free(device)
        numbers = runner.check(cell, raw, args.seed, device, world)
        runner.print_detail(numbers)
        bad = guard.loaded_forbidden()
        if bad:
            print(f"[portbench] forbidden modules loaded in rank 0: {sorted(bad)}",
                  file=sys.stderr)
            return 3
        out = runner.result(cell, raw, numbers, metrics, block, traced)
        with open(Path(args.out) / "result.json", "w") as f:
            json.dump(out, f)
        return 0
    finally:
        dist.destroy_process_group()


def _merge(cell, every, traced: bool, mine: Dict) -> Dict[str, float]:
    """Per-layer readings: the mean over the ranks that read one. End to
    end: rank 0's rate (its images are the global batch's), the slowest
    rank's set-up."""
    if traced:
        names = {k for e in every for k in e["metrics"]}
        return {k: statistics.fmean(e["metrics"][k] for e in every if k in e["metrics"])
                for k in sorted(names)}
    out = dict(mine["metrics"])
    if "setup_s" in out:
        out["setup_s"] = max(e["setup_s"] for e in every)
    return out
