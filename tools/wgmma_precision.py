"""How many bits below its largest product one tensor-core instruction keeps
when it sums products from zero: fp8 wgmma (m64n8k32), f16 wgmma (m64n8k16)
and fp8 mma.sync (m16n8k32), each on the H100 (tools/wgmma_precision.cu).

Row r of A holds 1 and -1 (channels 0 and 1) and 2^-a at channel s; B is 1,
except 2^-(step n) in column n at the channels s (step 1 in e4m3, whose
smallest value is 2^-9, else 2): the exact sum is 2^-(a + step n). The
script prints, per instruction and channel s, the smallest 2^-e that survives
exactly and the first that is lost. One CUDA card:

    python tools/wgmma_precision.py
"""

import ctypes
import os
import subprocess
import tempfile

import torch

here = os.path.dirname(os.path.abspath(__file__))
lib_path = os.path.join(tempfile.mkdtemp(), "wgmma_precision.so")
subprocess.run(["nvcc", "-gencode=arch=compute_90a,code=sm_90a", "-O3", "-shared", "-Xcompiler",
                "-fPIC", "-o", lib_path, os.path.join(here, "wgmma_precision.cu")], check=True)
lib = ctypes.CDLL(lib_path)
lib.run_probe.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
lib.run_probe.restype = ctypes.c_int

# mode: (name, operand dtype, K of one instruction, small channels, exponents a)
MODES = {
    0: ("fp8 wgmma m64n8k32 e5m2", torch.float8_e5m2, 32, (2, 8, 16, 31), range(0, 17, 2)),
    1: ("fp8 wgmma m64n8k32 e4m3", torch.float8_e4m3fn, 32, (2, 8, 16, 31), range(0, 10, 1)),
    2: ("f16 wgmma m64n8k16", torch.float16, 16, (2, 8, 15), range(0, 25, 2)),
    3: ("fp8 mma.sync m16n8k32 e5m2", torch.float8_e5m2, 32, (2, 8, 16, 31), range(0, 17, 2)),
    4: ("fp8 mma.sync m16n8k32 e4m3", torch.float8_e4m3fn, 32, (2, 8, 16, 31), range(0, 10, 1)),
}


def core_matrices(t: torch.Tensor) -> torch.Tensor:
    """(rows, K) -> bytes in the no-swizzle K-major order [K / kc][rows][kc]."""
    rows, k = t.shape
    b = t.contiguous().view(torch.uint8).reshape(rows, k * t.element_size() // 16, 16)
    return b.permute(1, 0, 2).contiguous().reshape(-1)


print(f"card: {torch.cuda.get_device_name(0)}")
for mode, (name, dtype, k, small, avals) in MODES.items():
    pos = [(s, a) for s in small for a in avals]
    assert len(pos) <= 64
    a = torch.zeros((64, k))
    for r, (s, e) in enumerate(pos):
        a[r, 0], a[r, 1], a[r, s] = 1.0, -1.0, 2.0 ** -e
    step = 1 if dtype == torch.float8_e4m3fn else 2
    b = torch.ones((8, k))  # B as (N, K)
    for n in range(8):
        b[n, list(small)] = 2.0 ** (-step * n)
    ab, bb = core_matrices(a.to(dtype)).cuda(), core_matrices(b.to(dtype)).cuda()
    d = torch.zeros((64, 8), device="cuda")
    code = lib.run_probe(ab.data_ptr(), bb.data_ptr(), d.data_ptr(), mode)
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code}")
    d = d.cpu()
    for s in small:
        kept, lost = [], []
        for r, (s_r, e) in enumerate(pos):
            if s_r != s:
                continue
            for n in range(8):
                (kept if float(d[r, n]) == 2.0 ** -(e + step * n) else lost).append(e + step * n)
        print(f"{name}, small product at channel {s}: exact down to 2^-{max(kept) if kept else '?'}, "
              f"first lost 2^-{min(lost) if lost else 'none'}", flush=True)
