"""Build, load and call the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled for Hopper (``sm_90a``) by its own ``nvcc``
process, all started together, and the objects are linked into one shared
library with a plain C interface. The library lands in ``build/`` beside this
file (listed in ``.gitignore``) under a name that hashes the sources and the
flags, so a changed source rebuilds and an unchanged one loads at once. The
build happens at the first launch of any kernel, never at import.

The library is loaded with ``ctypes``: pointers and the stream go over as
``c_void_p``, and each C entry point returns ``cudaGetLastError()``, which
``check`` turns into an exception.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
ARCH_FLAG = "-gencode=arch=compute_90a,code=sm_90a"
COMPILE_FLAGS = (ARCH_FLAG, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes of csrc/common.cuh.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_library = None
_functions: dict = {}
# What nvcc printed while building the library this process loaded
# (``-Xptxas -v``: registers, shared memory and spills of every kernel).
build_log = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc was not found on PATH or under CUDA_HOME; the CUDA toolkit is "
        "needed to build the kernels"
    )


def _source_tag() -> str:
    digest = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return digest.hexdigest()[:16]


def build() -> tuple[Path, str]:
    """Compile and link the kernels unless an up-to-date library exists.

    Returns the library's path and nvcc's output ("" when it was cached).
    """
    tag = _source_tag()
    lib_path = BUILD_DIR / f"libunet_kernels_{tag}.so"
    if lib_path.exists():
        return lib_path, ""
    nvcc = _nvcc()
    obj_dir = BUILD_DIR / f"obj_{tag}"
    obj_dir.mkdir(parents=True, exist_ok=True)
    sources = sorted(CSRC_DIR.glob("*.cu"))
    jobs = [
        (src, obj_dir / f"{src.stem}.o",
         subprocess.Popen(
             [nvcc, *COMPILE_FLAGS, "-c", str(src), "-o", str(obj_dir / f"{src.stem}.o")],
             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for src in sources
    ]
    log, failed = [], []
    for src, _, proc in jobs:
        out, _ = proc.communicate()
        log.append(f"[nvcc {src.name}]\n{out.strip()}")
        if proc.returncode != 0:
            failed.append(src.name)
    text = "\n".join(log)
    if failed:
        raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{text}")
    tmp = lib_path.with_name(f"{lib_path.stem}.{os.getpid()}.tmp.so")
    link = subprocess.run(
        [nvcc, ARCH_FLAG, "-shared", "-o", str(tmp), *(str(obj) for _, obj, _ in jobs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
    os.replace(tmp, lib_path)
    return lib_path, text


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _library, build_log
    if _library is None:
        path, build_log = build()
        lib = ctypes.CDLL(str(path))
        lib.unet_error_string.argtypes = [ctypes.c_int]
        lib.unet_error_string.restype = ctypes.c_char_p
        _library = lib
    return _library


def kernel_function(name: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry point ``name`` of the library, typed with ``argtypes`` (at
    its first call: a wrapper passes the same types every time)."""
    fn = _functions.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _functions[name] = fn
    return fn


def check(code: int, name: str) -> None:
    """Raise when a C entry point returned a CUDA error."""
    if code != 0:
        message = library().unet_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({message})")


def uses_kernel(*tensors: torch.Tensor) -> bool:
    """Whether a wrapper launches its kernel (CUDA tensors) or runs its
    plain version (CPU tensors). Any other device, or a mix, raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"tensors must all be on the CPU or all on CUDA, got {sorted(kinds)}")


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """For a forward-only kernel (K3, inference only as in JAX): a CUDA call
    that autograd would record raises instead of computing a result with no
    backward."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward; call it under torch.no_grad() or "
            "torch.inference_mode()"
        )


@functools.lru_cache(maxsize=None)
def device_limits(index: int) -> tuple[int, int]:
    """(SM count, shared memory a block may take after an opt-in) of CUDA
    device ``index``: what a persistent kernel's plan is cut to."""
    fn = kernel_function("unet_device_limits", [ctypes.POINTER(ctypes.c_int)] * 2)
    sms, smem = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(index):
        code = fn(ctypes.byref(sms), ctypes.byref(smem))
    check(code, "unet_device_limits")
    return sms.value, smem.value


def on_device(device: torch.device):
    """A context that makes ``device`` current for a launch, or nothing when
    it already is (the common case, and the cheap one)."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def stream_of(tensor: torch.Tensor) -> int:
    return torch.cuda.current_stream(tensor.device).cuda_stream
