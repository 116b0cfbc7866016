"""A small copy of the benchmark for tests on the CPU: a 3-stage UNet at 32
pixels in float32, with train and predict cells of a few images, written
into a directory beside copies of the real traffic files and metric
readers. ``cell(root, name)`` then looks it up as ``run.py`` would."""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Dict

from pb import manifest

TINY_CONFIG = {
    "name": "tiny_unet", "source": "test", "reference": "reference/unet.py",
    "features_per_stage": [8, 16, 32], "strides": [1, 2, 2], "kernel_size": 3,
    "in_channels": 3, "num_classes": 3, "n_conv_per_stage": 2, "n_conv_per_stage_decoder": 2,
    "encoder_dropout": [0.0, 0.1, 0.2], "decoder_dropout": [0.2, 0.1], "image_size": 32,
    "dtype": "float32", "param_dtype": "float32", "layout": "dense",
    "optimizer": {"name": "sgd_nesterov", "lr": 0.005, "momentum": 0.99, "weight_decay": 1e-4,
                  "weight_ce": 1.0, "weight_dice": 1.0},
}

TINY_CLIP = {**TINY_CONFIG, "name": "tiny_clip", "clip_fusion": True, "clip_dim": 512,
             "clip_tower": {"name": "ViT-B/16", "image_size": 224, "patch_size": 16,
                            "width": 768, "layers": 12, "heads": 12, "mlp_ratio": 4,
                            "output_dim": 512}}

TRAIN = {"driver": "train", "batch": 4, "ring": 4,
         "limits": {"loss_gap": 1e-3, "grad_gap": 1e-2,
                    "grad_gap_worst": 1e-2, "change_gap": 1e-2, "change_gap_worst": 1e-2}}
PREDICT = {"driver": "predict", "batch": 4, "ring": 2,
           "sizes": [{"h": 24, "w": 32, "share": 0.5}, {"h": 40, "w": 30, "share": 0.5}],
           "limits": {"mask_gap": 1e-3}}
CLIP_TRAIN = {**TRAIN, "clip": True, "batch": 2}


def write(root: Path, extra_workloads=(), extra_configs=(), extra_per_layer=()) -> Path:
    """A benchmark root at ``root`` with the tiny cells ``tiny-train`` and
    ``tiny-predict`` and the real manifest's metrics; returns ``root``."""
    real = manifest.load()
    bench = root / "portbench"
    for sub in ("metrics", "traffic"):
        shutil.copytree(manifest.BENCH_DIR / sub, bench / sub, dirs_exist_ok=True)
    (bench / "configs").mkdir(parents=True, exist_ok=True)
    (bench / "configs" / "tiny_unet.json").write_text(json.dumps(TINY_CONFIG))
    (bench / "configs" / "tiny_clip.json").write_text(json.dumps(TINY_CLIP))
    (bench / "traffic" / "tiny_clip_train.json").write_text(json.dumps(CLIP_TRAIN))
    (bench / "traffic" / "tiny_train.json").write_text(json.dumps(TRAIN))
    (bench / "traffic" / "tiny_predict.json").write_text(json.dumps(PREDICT))
    cells = [("tiny-train", "tiny_train", {"train_images_per_s"}, "tiny_unet"),
             ("tiny-predict", "tiny_predict", {"serve_images_per_s", "predict_p95_ms"},
              "tiny_unet"),
             ("tiny-clip", "tiny_clip_train", {"clip_train_images_per_s"}, "tiny_clip")]
    out: Dict = dict(real)
    out["configs"] = [{"name": "tiny_unet", "source": "test",
                       "file": "portbench/configs/tiny_unet.json", "reduced": [],
                       "why": "test"},
                      {"name": "tiny_clip", "source": "test",
                       "file": "portbench/configs/tiny_clip.json", "reduced": [],
                       "why": "test"}, *extra_configs]
    out["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": 1, "why": "test"}
                        for n, t, _, c in cells] + list(extra_workloads)
    # Two ranks of the tiny train cell (gloo on the CPU).
    out["workloads"].append({"name": "tiny-dp", "config": "tiny_unet", "traffic": "tiny_train",
                             "chips": 2, "why": "test"})
    cells.append(("tiny-dp", "tiny_train", {"train_images_per_s"}, "tiny_unet"))
    names = [w["name"] for w in out["workloads"]]
    e2e = []
    for m in real["end_to_end"]:
        m = dict(m)
        if "workloads" in m:
            m["workloads"] = [n for n, _, reports, _ in cells if m["name"] in reports] or names
        e2e.append(m)
    out["end_to_end"] = e2e
    per = []
    for m in real["per_layer"]:
        m = dict(m)
        m["workloads"] = [n for n, _, reports, _ in cells if m["moves"] in reports
                          and n.split("-")[1] == m["name"].rsplit(".", 1)[-1].replace(
                              "serve", "predict").replace("dp4", "none")]
        per.append(m)
    out["per_layer"] = per + list(extra_per_layer)
    (root / "BENCHMARK.json").write_text(json.dumps(out, indent=1))
    return root


def cell(root: Path, name: str) -> manifest.Cell:
    return manifest.cell(name, root, root / "portbench")
