"""A later change adds a cell, a configuration and a per-layer metric with
new files and manifest entries alone: no file of the harness is edited."""

import hashlib
import json
import sys
import time
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

from pb import runner, tiny  # noqa: E402


def digest(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*.py")) if "__pycache__" not in p.parts}


def test_cell_config_and_metric_from_files(tmp_path):
    before = digest(HERE)
    root = tmp_path
    bench = root / "portbench"
    config = dict(tiny.TINY_CONFIG, name="tiny_wide", features_per_stage=[16, 24, 48],
                  encoder_dropout=[0.0, 0.0, 0.1], decoder_dropout=[0.1, 0.0])
    traffic = dict(tiny.TRAIN, batch=2, ring=3)
    tiny.write(
        root,
        extra_configs=[{"name": "tiny_wide", "source": "test", "reduced": [], "why": "test",
                        "file": "portbench/configs/tiny_wide.json"}],
        extra_workloads=[{"name": "tiny-wide-train", "config": "tiny_wide",
                          "traffic": "tiny_wide_train", "chips": 1, "why": "test"}],
        extra_per_layer=[{"name": "steps_in_window.train", "unit": "steps", "better": "higher",
                          "source": "host_clock", "layer": "loop and step dispatch",
                          "moves": "train_images_per_s", "workloads": ["tiny-wide-train"]}])
    (bench / "configs" / "tiny_wide.json").write_text(json.dumps(config))
    (bench / "traffic" / "tiny_wide_train.json").write_text(json.dumps(traffic))
    (bench / "metrics" / "steps_in_window.train.py").write_text(
        "def read(run):\n    return run.raw['steps']\n")
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    for m in manifest["end_to_end"]:
        if m["name"] == "train_images_per_s":
            m["workloads"].append("tiny-wide-train")
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))

    cell = tiny.cell(root, "tiny-wide-train")
    assert cell.config["features_per_stage"] == [16, 24, 48]
    untraced = runner.run_cell(cell, 31, 0.3, False, torch.device("cpu"), time.perf_counter())
    assert untraced["correct"] and set(untraced["metrics"]) == {"train_images_per_s", "setup_s"}
    traced = runner.run_cell(tiny.cell(root, "tiny-wide-train"), 31, 0.3, True,
                             torch.device("cpu"), time.perf_counter())
    assert traced["metrics"]["steps_in_window.train"]["value"] == traced["attempted"]
    assert digest(HERE) == before


@pytest.mark.parametrize("where,key,value,named", [
    ("config", "layout", "s2d", "layout"),
    ("config", "param_dtype", "bfloat16", "param_dtype"),
    ("config", "remat", True, "remat"),
    ("traffic", "rate_per_s", 4.0, "rate_per_s"),
    ("traffic", "driver", "replay", "replay"),
], ids=["layout", "param_dtype", "config_key", "traffic_key", "driver"])
def test_unread_key_is_refused(tmp_path, where, key, value, named):
    """A configuration or traffic file that asks for something its driver
    would not do is refused, naming what, and never run as something else."""
    root = tiny.write(tmp_path)
    name = "tiny_unet.json" if where == "config" else "tiny_train.json"
    path = root / "portbench" / ("configs" if where == "config" else "traffic") / name
    data = json.loads(path.read_text())
    data[key] = value
    path.write_text(json.dumps(data))
    with pytest.raises(ValueError, match=named):
        tiny.cell(root, "tiny-train")
