"""``run.py``'s refusals: without a card, and in a directory that holds only
``BENCHMARK.json`` and the benchmark's own files, it prints no result and
exits with a code other than 0."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def run(cwd: Path, *extra):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"][0]["name"],
                           "--seed", str(2 ** 33 + 5), "--seconds", "1", "--trace", "0", *extra],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    done = run(ROOT)
    assert done.returncode != 0 and done.stdout.strip() == ""


def test_benchmark_files_alone_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    done = run(tmp_path)
    assert done.returncode != 0 and done.stdout.strip() == ""
