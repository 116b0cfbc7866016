"""A data-parallel cell's run as two gloo ranks on the CPU: sound, its
averaged update agrees with the reference's step on the global batch; with
the exchange between the ranks left out, ``correct`` comes out false; with
JAX loaded in one rank, no rank gives a result."""

import json
import socket
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent

WORKER = """
import sys, time, json, argparse, types
sys.path[:0] = [{here!r}, {root!r}]
from pathlib import Path
from pb import tiny, ranks

def no_exchange(step, model, optimizer):
    def broken(batch, generator):
        with model.no_sync():
            return step(batch, generator)
    return broken

cell = tiny.cell(Path({tiny!r}), "tiny-dp")
args = argparse.Namespace(rank={rank}, port={port}, seed=41, seconds=0.5, trace=0,
                          out={tiny!r})
faults = {{"step": no_exchange}} if {broken} else None
if {rank} == {plant}:
    sys.modules["jax"] = types.ModuleType("jax")
sys.exit(ranks.worker(cell, args, time.perf_counter(), faults))
"""


def _port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(root: Path, broken: bool, plant: int = -1):
    sys.path.insert(0, str(HERE))
    from pb import tiny
    tiny.write(root)
    port = _port()
    procs = [subprocess.Popen([sys.executable, "-c", WORKER.format(
        here=str(HERE), root=str(HERE.parent), tiny=str(root), rank=r, port=port,
        broken=broken, plant=plant)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    return procs, [p.communicate(timeout=600) for p in procs]


def _run(root: Path, broken: bool) -> dict:
    procs, outs = _start(root, broken)
    assert all(p.returncode == 0 for p in procs), [o[1][-2000:] for o in outs]
    return json.loads((root / "result.json").read_text())


def test_two_ranks_agree_with_the_global_step(tmp_path):
    out = _run(tmp_path, broken=False)
    assert out["correct"], out["checks"]
    assert out["device"]["count"] == 2


def test_exchange_left_out_is_not_correct(tmp_path):
    out = _run(tmp_path, broken=True)
    assert not out["correct"], out["checks"]


def test_jax_in_one_rank_gives_no_result(tmp_path):
    procs, outs = _start(tmp_path, broken=False, plant=1)
    assert [p.returncode for p in procs] == [3, 3], [o[1][-2000:] for o in outs]
    assert "jax" in outs[0][1] and "jax" in outs[1][1]
    assert not (tmp_path / "result.json").exists()
