#!/usr/bin/env python3
"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. It needs CUDA cards (as many as the cell
asks for) and the port, ``unet_implementations_tpu_torch``, beside it; it
exits with code 2 without them, and 3 if JAX or the JAX package got loaded.
Its last line on standard output is the result: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace 1``
its per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each number compared beside its limit (also the last lines on
standard error).

A cell on several cards starts one process a card (``--rank``), each on its
own card, joined over NCCL; this process uses no card and prints rank 0's
result.
"""

import time

T0 = time.perf_counter()
STARTED = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Caches at fixed paths inside the checkout (listed in .gitignore), so that
# only a cell's first run in a checkout builds or compiles. The port builds
# its kernels into its own package directory, inside the checkout too.
CACHE = HERE / "_cache"
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(ROOT))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--out", default=None, help=argparse.SUPPRESS)
    p.add_argument("--started", type=float, default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def fail(message: str, code: int) -> int:
    print(f"[portbench] {message}", file=sys.stderr)
    return code


def main(argv=None) -> int:
    args = parse(argv)
    try:
        from pb import manifest
        cell = manifest.cell(args.workload)
    except (OSError, KeyError, ValueError) as exc:
        return fail(f"cannot read the cell: {exc!r}", 2)
    if not (ROOT / "unet_implementations_tpu_torch" / "__init__.py").is_file():
        return fail("the port, unet_implementations_tpu_torch, is not beside the benchmark", 2)
    if args.rank is not None:
        from pb import ranks
        # Set-up counts from the launching process's start.
        t0 = T0 if args.started is None else T0 - (STARTED - args.started)
        return ranks.worker(cell, args, t0)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        return fail(f"{cell.name} needs {cell.chips} CUDA card(s); "
                    f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", 2)
    from pb import diag, guard
    diag.report("before")
    if cell.chips > 1:
        from pb import ranks
        out = ranks.launch(cell, args, HERE / "run.py", STARTED)
        if out is None:
            return fail("a rank failed; no result", 1)
    else:
        from pb import runner
        out = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), T0)
    diag.report("after")
    bad = guard.loaded_forbidden()
    if bad:
        return fail(f"forbidden modules loaded in this process: {sorted(bad)}", 3)
    for name, c in out["checks"].items():
        print(f"[portbench] check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
