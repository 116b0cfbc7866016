"""``BENCHMARK.json`` and the files it names.

Everything of one cell is found by name: its workload entry in the
manifest, its configuration (the entry's ``file``), its traffic mix
(``<bench>/traffic/<traffic>.json``), the driver its traffic names
(``pb/drivers/<driver>.py``) and each metric's reader
(``<bench>/metrics/<metric name>.py``, a module with ``read(run)``; where
there is none, the reader of the name before its last dot, so that
``mfu_pct.train`` and ``mfu_pct.clip`` share ``mfu_pct.py``). A later change
adds a cell, a configuration, a kind of traffic or a metric by adding such
files and manifest entries, never by editing a file that is there. A key of
a configuration or traffic file that its driver does not read is refused.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

from pb import drivers

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    root: Path
    bench: Path
    driver: ModuleType
    readers: Dict[str, Callable] = field(default_factory=dict)


def load(root: Path = ROOT) -> Dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: Dict, cell: str, e2e_names: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def reader_path(bench: Path, name: str) -> Path:
    """``metrics/<name>.py``, or else ``metrics/<name before its last dot>.py``."""
    path = bench / "metrics" / f"{name}.py"
    if not path.is_file() and "." in name:
        path = bench / "metrics" / f"{name.rsplit('.', 1)[0]}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r} in {bench / 'metrics'}")
    return path


def reader(bench: Path, name: str) -> Callable:
    """``read(run) -> float | None`` of metric ``name``."""
    path = reader_path(bench, name)
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell(name: str, root: Path = ROOT, bench: Optional[Path] = None) -> Cell:
    manifest = load(root)
    bench = BENCH_DIR if bench is None else bench
    entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}")
    conf = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    with open(root / conf["file"]) as f:
        config = json.load(f)
    with open(bench / "traffic" / f"{entry['traffic']}.json") as f:
        traffic = json.load(f)
    e2e = [m for m in manifest["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    names = [m["name"] for m in e2e]
    per_layer = [m for m in manifest["per_layer"] if _reports(m, name, names)]
    driver = drivers.validate(name, traffic, config)
    out = Cell(name, entry["chips"], config, traffic, e2e, per_layer, root, bench, driver)
    out.readers = {m["name"]: reader(bench, m["name"]) for m in e2e + per_layer}
    return out
