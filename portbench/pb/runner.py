"""One run of one cell: the timed window (the cell's driver, ``pb/drivers``), then the
comparison with the plain reference, then the metrics by their readers, as one result line.

``run_cell`` takes the device it is given and looks for no card: ``run.py``
does that. Tests drive it on the CPU with a small configuration, and with a
fault planted in the timed path (``faults``), to see ``correct`` come out
false.
"""

from __future__ import annotations

import sys
from types import SimpleNamespace
from typing import Dict, Optional

import torch

from pb import compare


def _free(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def drive(cell, seed: int, seconds: float, traced: bool, device: torch.device, t0: float,
          faults: Optional[Dict] = None, rank: int = 0, world: int = 1, control=None) -> Dict:
    """The raw output of the cell's traffic, by its driver, for this process."""
    return cell.driver.run(cell, seed, seconds, traced, device, t0, faults, rank=rank,
                           world=world, control=control)


def check(cell, raw: Dict, seed: int, device: torch.device, world: int = 1) -> Dict:
    """The numbers that decide ``correct``, by the cell's driver."""
    return cell.driver.check(cell, raw, seed, device, world)


def read_metrics(cell, raw: Dict, traced: bool, chips: int) -> Dict[str, float]:
    """This process's readings of the cell's end-to-end metrics (untraced)
    or per-layer metrics (traced); a reader that finds nothing gives None
    and the metric is left out."""
    run = SimpleNamespace(cell=cell, cfg=cell.config, traffic=cell.traffic, raw=raw,
                          trace=raw.get("trace"), chips=chips)
    wanted = cell.per_layer if traced else cell.end_to_end
    out = {}
    for m in wanted:
        value = cell.readers[m["name"]](run)
        if value is not None:
            out[m["name"]] = float(value)
    return out


def device_info(raw: Dict, chips: int, device: torch.device, traced: bool,
                busy=None, window=None) -> Dict:
    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": chips, "memory_peak_bytes": int(raw["memory_peak_bytes"])}
    if traced:
        trace = raw["trace"]
        info["busy_s"] = trace.busy_s() if busy is None else busy
        info["window_s"] = trace.window_s if window is None else window
    return info


def result(cell, raw: Dict, numbers: Dict, metrics: Dict[str, float], device_block: Dict,
           traced: bool) -> Dict:
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    ok, checks = compare.verdict(numbers, cell.traffic["limits"])
    attempted = raw.get("requests", raw.get("steps", 0))
    out = {"correct": bool(ok), "attempted": int(attempted), "failed": int(raw.get("failed", 0)),
           "metrics": {k: {"value": v, "unit": units[k]} for k, v in metrics.items()},
           "device": device_block}
    if traced and raw.get("trace") is not None:
        out["breakdown"] = raw["trace"].breakdown()
    out["checks"] = checks
    return out


def run_cell(cell, seed: int, seconds: float, traced: bool, device: torch.device, t0: float,
             faults: Optional[Dict] = None) -> Dict:
    """One process's whole run of a one-card cell: window, reference,
    metrics; the result line's dict."""
    raw = drive(cell, seed, seconds, traced, device, t0, faults)
    metrics = read_metrics(cell, raw, traced, cell.chips)
    block = device_info(raw, cell.chips, device, traced)
    _free(device)
    numbers = check(cell, raw, seed, device)
    print_detail(numbers)
    return result(cell, raw, numbers, metrics, block, traced)


def print_detail(numbers: Dict) -> None:
    for k, v in numbers.get("detail", {}).items():
        print(f"[portbench] check detail {k}: {v}", file=sys.stderr)
