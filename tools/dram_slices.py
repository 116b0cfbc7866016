"""DRAM's rate for slices of a pixel: reads every pixel's 16-byte vectors
[lo, lo + cnt) of an NHWC bf16 tensor, one launch a slice, and pieces of
pixels x a slice on 132 blocks, at the pixel widths of levels 0, 1 and 4 of
unet_6stage at b32 512². Prints GB/s of bytes read. One CUDA card:

    python tools/dram_slices.py
"""

import ctypes
import os
import statistics
import subprocess
import tempfile

import torch

here = os.path.dirname(os.path.abspath(__file__))
lib_path = os.path.join(tempfile.mkdtemp(), "dram_slices.so")
subprocess.run(["nvcc", "-gencode=arch=compute_90a,code=sm_90a", "-O3", "-shared", "-Xcompiler",
                "-fPIC", "-o", lib_path, os.path.join(here, "dram_slices.cu")], check=True)
lib = ctypes.CDLL(lib_path)
lib.launch_rd.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
lib.launch_pieces.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
out = torch.zeros(1, dtype=torch.int32, device="cuda")
def t(fn, n=10):
    fn(); torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    for s, e in ev:
        s.record(); fn(); e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)
for name, npix, nvp in [("level0 64B px", 32 * 512 * 512, 4), ("level1 128B px", 32 * 256 * 256, 8), ("level4 1KB px", 32 * 32 * 32, 64)]:
    x = torch.empty(npix * nvp * 8, dtype=torch.bfloat16, device="cuda").normal_()
    nbytes = x.numel() * 2
    for cnt in sorted({nvp, 8, 4, 2} & set(range(1, nvp + 1))):
        ms = t(lambda: [lib.launch_rd(x.data_ptr(), npix, nvp, lo, cnt, out.data_ptr(), 132 * 8, 512) for lo in range(0, nvp, cnt)])
        print(f"{name}: all pixels, {cnt * 16} B slices one launch each ({nvp // cnt} launches): {ms:.3f} ms, {nbytes / ms / 1e6:.0f} GB/s", flush=True)
    for cnt, part_px in [(2, 1986), (2, 1024), (nvp, 1024), (nvp, 1986)]:
        if cnt > nvp: continue
        ms = t(lambda: lib.launch_pieces(x.data_ptr(), npix, nvp, cnt, part_px, out.data_ptr(), 132, 512))
        print(f"{name}: pieces of {part_px} px x {cnt * 16} B, 132 blocks: {ms:.3f} ms, {nbytes / ms / 1e6:.0f} GB/s", flush=True)
    del x
