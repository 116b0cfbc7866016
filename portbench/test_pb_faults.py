"""A run with its timed path broken underneath comes out not correct: the
harness's look for a card skipped, the rest of the run driven as it is, on
the CPU at a tiny size. One test a fault the cells can have."""

import sys
import time
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

from pb import runner, tiny  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.write(tmp_path_factory.mktemp("tiny"))


def unchanged(step, model, optimizer):
    """A step that returns the state unchanged: the optimizer never steps."""
    def broken(batch, generator):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        return torch.zeros(())
    return broken


def half_batch(step, model, optimizer):
    """Half of the batch left out, the mean taken over the rest."""
    def broken(batch, generator):
        n = len(batch["image"]) // 2
        return step({k: v[:n] for k, v in batch.items()}, generator)
    return broken


@pytest.mark.parametrize("fault", [unchanged, half_batch], ids=["unchanged", "half_batch"])
@pytest.mark.parametrize("name", ["tiny-train", "tiny-clip"])
def test_training_fault_is_not_correct(root, fault, name):
    out = runner.run_cell(tiny.cell(root, name), 21, 0.3, False, CPU, time.perf_counter(),
                          faults={"step": fault})
    assert not out["correct"], out["checks"]


def test_altered_answer_is_not_correct(root):
    """One served mask altered where it is produced."""
    def alter(k, masks):
        masks = list(masks)
        masks[0] = (masks[0] + 1) % 3
        return masks

    out = runner.run_cell(tiny.cell(root, "tiny-predict"), 22, 0.3, False, CPU,
                          time.perf_counter(), faults={"answer": alter})
    assert not out["correct"], out["checks"]
