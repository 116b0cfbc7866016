"""The plain reference against the port at a tiny size on the CPU (float32,
where the two must agree to rounding), the reference's blocks against one
block, and the controls: computed in a lower precision, the comparison
comes out not correct."""

import sys
import time
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

from pb import compare, runner, tiny, weights  # noqa: E402
from pb.drivers import train as train_driver  # noqa: E402
from reference import unet as ref_unet  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.write(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("name", ["tiny-train", "tiny-predict", "tiny-clip"])
def test_port_agrees_with_reference(root, name):
    out = runner.run_cell(tiny.cell(root, name), 2 ** 40 + 3, 0.3, False, CPU, time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    for check in out["checks"].values():
        assert check["value"] <= check["limit"] / 10


def test_blocks_give_the_full_batch_step(root):
    cell = tiny.cell(root, "tiny-train")
    cfg = cell.config
    params = weights.make(ref_unet.param_shapes(cfg), 11, 3, CPU)
    batches = train_driver.reference_batches(cell, 11, 1, CPU)
    whole = ref_unet.train_steps(cfg, params, batches, cfg["optimizer"], block=4)
    split = ref_unet.train_steps(cfg, params, batches, cfg["optimizer"], block=1)
    assert whole["losses"] == pytest.approx(split["losses"], rel=1e-6)
    for k in params:
        torch.testing.assert_close(whole["params"][k], split["params"][k], rtol=1e-5, atol=1e-7)


def test_training_control_fails(root):
    """The reference in fp8 in the program's place: the tiny cell's limits
    refuse it."""
    cell = tiny.cell(root, "tiny-train")
    cfg = cell.config
    params = weights.make(ref_unet.param_shapes(cfg), 12, 3, CPU)
    batches = train_driver.reference_batches(cell, 12, 1, CPU)
    ref = ref_unet.train_steps(cfg, params, batches, cfg["optimizer"], block=4)
    low = ref_unet.train_steps(cfg, params, batches, cfg["optimizer"], block=4, precision="fp8")
    numbers = compare.train_numbers(low, ref, params)
    ok, _ = compare.verdict(numbers, cell.traffic["limits"])
    assert not ok


def test_serving_control_fails(root, monkeypatch):
    """The program's own fp8 conv mode in place of bf16 (the mode takes
    bf16 and float16 values only): the bf16 program passes a limit that the
    control fails (tiny readings: bf16 0.05-0.15, fp8 2.1-4.4)."""
    def run():
        cell = tiny.cell(root, "tiny-predict")
        cell.config["dtype"] = "bfloat16"
        cell.traffic["limits"] = {"mask_gap": 0.5}
        return runner.run_cell(cell, 13, 0.3, False, CPU, time.perf_counter())

    assert run()["correct"]
    monkeypatch.setenv("UNET_TPU_CONV_FP8", "all")
    assert not run()["correct"]


def test_mask_gap_reads_a_wrong_size():
    logits = torch.zeros((1, 8, 8, 3))
    import numpy as np
    assert compare.mask_gap([np.zeros((4, 4), np.uint8)], [(5, 4)], logits) == float("inf")
    assert compare.mask_gap([np.zeros((5, 4), np.uint8)], [(5, 4)], logits) == 0.0
