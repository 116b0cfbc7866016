"""The harness's operation and byte counts against counts by hand."""

import json
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

from pb import counts  # noqa: E402

CFG = json.loads((HERE / "configs" / "unet_6stage.json").read_text())
CLIP = json.loads((HERE / "configs" / "clip_unet.json").read_text())


def hand_macs():
    """unet_6stage at 512 px, stage by stage: (resolution, cin, cout) of each
    3x3 conv, then the 1x1 head."""
    convs = [(512, 3, 32), (512, 32, 32), (256, 32, 64), (256, 64, 64), (128, 64, 128),
             (128, 128, 128), (64, 128, 256), (64, 256, 256), (32, 256, 512), (32, 512, 512),
             (16, 512, 512), (16, 512, 512),
             (32, 1024, 512), (32, 512, 512), (64, 768, 256), (64, 256, 256),
             (128, 384, 128), (128, 128, 128), (256, 192, 64), (256, 64, 64),
             (512, 96, 32), (512, 32, 32)]
    return sum(r * r * 9 * a * b for r, a, b in convs) + 512 * 512 * 32 * 3


def test_unet_forward_flops():
    assert counts.unet_forward_flops(CFG) == 2 * hand_macs()
    assert counts.unet_forward_flops(CFG) == pytest.approx(128.547e9, rel=1e-4)


def test_step_flops():
    assert counts.step_flops_per_image(CFG, train=True) == 3 * counts.unet_forward_flops(CFG)
    fusion = 2 * 16 * 16 * 1024 * 512
    assert counts.step_flops_per_image(CLIP, train=True) == pytest.approx(
        3 * (2 * hand_macs() + fusion) + counts.clip_tower_flops(CLIP["clip_tower"]))


def test_clip_tower_flops():
    w, t = 768, 197
    block = t * (4 * w * w + 8 * w * w) + 2 * t * t * w
    macs = 196 * 768 * w + 12 * block + w * 512
    assert counts.clip_tower_flops(CLIP["clip_tower"]) == 2 * macs


def test_k1_bytes():
    # Each norm's input read and output written once, bf16: the 22 sites.
    sites = [(512, 32)] * 2 + [(256, 64)] * 2 + [(128, 128)] * 2 + [(64, 256)] * 2 + \
        [(32, 512)] * 2 + [(16, 512)] * 2 + [(32, 512)] * 2 + [(64, 256)] * 2 + \
        [(128, 128)] * 2 + [(256, 64)] * 2 + [(512, 32)] * 2
    elems = sum(r * r * c for r, c in sites)
    assert counts.k1_bytes(CFG, 128) == 128 * elems * 2 * 2
    assert counts.k1bwd_bytes(CFG, 32) == 32 * elems * 3 * 2
    # chip_smoke.py's bound of K1 on a b128 forward, 9.976 ms at 3.35 TB/s.
    assert counts.k1_bytes(CFG, 128) / counts.HBM_BYTES_PER_S == pytest.approx(9.976e-3, rel=1e-3)
