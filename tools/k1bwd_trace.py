"""Times each handoff of the fused K1bwd kernel (reduce, the publisher's
barrier and row, the waiter's count, the pool, the apply) per piece and block,
from globaltimer stamps in an instrumented copy of the source
(tools/k1bwd_trace_source.py), at four b32 shapes. Run from the repo root on
one CUDA card:

    python tools/k1bwd_trace.py

Only shapes the fused kernel takes give stamps (bwd_plan's `fused`).
"""

import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, root)
csrc = os.path.join(root, "unet_implementations_tpu_torch", "kernels", "csrc")
out = tempfile.mkdtemp()
subprocess.run([sys.executable, os.path.join(root, "tools", "k1bwd_trace_source.py"),
                os.path.join(out, "in_trace.cu")], check=True)
subprocess.run(["nvcc", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-I", csrc,
                "-shared", "-Xcompiler", "-fPIC", "-o", os.path.join(out, "lib.so"),
                os.path.join(out, "in_trace.cu"), os.path.join(csrc, "runtime.cu")], check=True)
from unet_implementations_tpu_torch.kernels import _build, instance_norm as k1
lib = ctypes.CDLL(os.path.join(out, "lib.so"))
lib.unet_error_string.argtypes = [ctypes.c_int]; lib.unet_error_string.restype = ctypes.c_char_p
lib.unet_trace_copy.argtypes = [ctypes.c_void_p]
_build._library = lib
import chip_smoke as cs
buf = np.zeros(132 * 256 * 8, np.uint64)
names = ["red0", "red1", "Psync", "publ", "Cready", "Wpooled", "Wseen", "applied"]
for side, c, g in [(128, 128, 1), (64, 256, 1), (32, 512, 1), (16, 512, 1)]:
    args = cs.k1_bwd_inputs(32, side, c, torch.bfloat16, g)
    for _ in range(3):
        k1._cuda_backward(*args, 0.01, g)
    torch.cuda.synchronize()
    lib.unet_trace_copy(buf.ctypes.data)  # clear by overwrite below
    t0 = torch.cuda.Event(enable_timing=True); t1 = torch.cuda.Event(enable_timing=True)
    t0.record(); k1._cuda_backward(*args, 0.01, g); t1.record(); torch.cuda.synchronize()
    lib.unet_trace_copy(buf.ctypes.data)
    plan = k1.bwd_plan(32, side * side, c, g, 2, 132, 232448)
    m = plan.pieces // plan.grid
    tr = buf.reshape(132, 256, 8)[:plan.grid, :m].astype(np.int64)
    base = tr[:, 0, 0].min()
    tr = tr - base
    print(f"== {(32, side, side, c)} g{g} plan parts {plan.parts} steps {plan.steps} ring {plan.ring_steps} pieces/block {m}: {t0.elapsed_time(t1):.3f} ms", flush=True)
    for i in list(range(min(m, 4))) + [m // 2, m - 1]:
        row = tr[:, i]
        med = np.median(row, axis=0) / 1000
        mx = row.max(axis=0) / 1000
        print(f"  piece {i}: median us " + " ".join(f"{n}={v:.2f}" for n, v in zip(names, med)) + " | max " + " ".join(f"{v:.2f}" for v in mx), flush=True)
    d = lambda a, b: np.median(tr[:, 1:m - 1, a] - tr[:, 1:m - 1, b]) / 1000
    print(f"  median durations us: reduce {d(1,0):.2f}, C->W {d(2,1):.2f}, publish {d(3,2):.2f}, waiter-seen-after-publ {d(6,3):.2f}, waiter-pool {d(5,6):.2f}, C-ready-after-pooled {d(4,5):.2f}, apply {d(7,4):.2f}, period {np.median(np.diff(tr[:, :, 7], axis=1)) / 1000:.2f}")
    del args; torch.cuda.empty_cache()
