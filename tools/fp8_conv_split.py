"""Where fp8_conv_wgmma_kernel's time goes: the kernel rebuilt from a copy of
csrc/ with one part taken out, timed at four b128 calls of a dense
unet_6stage forward (e5m2, bf16 x, random weights). Variants: the kernel
as it is; no wgmma (the consumers wait and release, the tensor cores idle);
no cast (the producer's casts and stores into the stage dropped); no loads
and no cast (the producer only walks its ring and barriers). Outputs of the
variants are wrong by design; only their times are read. Each variant runs
in its own process (one build each, under _proof/, which .gitignore lists).
One CUDA card:

    python tools/fp8_conv_split.py
"""

import shutil
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
CALLS = [((128, 512, 512, 32), (32, 32, 3, 3), 1), ((128, 512, 512, 64), (32, 64, 3, 3), 1),
         ((128, 256, 256, 64), (64, 64, 3, 3), 1), ((128, 32, 32, 512), (512, 512, 3, 3), 1),
         ((128, 512, 512, 32), (64, 32, 3, 3), 2)]
# The source lines each variant removes (csrc/fp8_conv.cu).
MMA = "if (t < tiles) mma<BN>(acc[t], a + t * 64, b);"
LOAD = "cp_async16(dst0 + u * kUnitBytes, src, ok ? 16u : 0u);"
STORE = "if (i < wp) *reinterpret_cast<uint4*>(dst + i * 16) = v[u];"
VARIANTS = {"kernel": [], "no wgmma": [MMA], "no cast": [STORE],
            "no loads, no cast": [LOAD, STORE]}


def run(name: str) -> None:
    sys.path.insert(0, str(REPO))
    import torch

    from unet_implementations_tpu_torch.kernels import _build
    from unet_implementations_tpu_torch.kernels import fp8_conv as k8

    tag = name.replace(" ", "").replace(",", "_")
    src = REPO / "unet_implementations_tpu_torch" / "kernels" / "csrc"
    dst = REPO / "_proof" / f"csrc_split_{tag}"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    text = (dst / "fp8_conv.cu").read_text()
    for line in VARIANTS[name]:
        if line not in text:
            raise SystemExit(f"{name}: the line to remove is gone from fp8_conv.cu: {line}")
        text = text.replace(line, "")
    (dst / "fp8_conv.cu").write_text(text)
    _build.CSRC_DIR = dst
    _build.BUILD_DIR = REPO / "_proof" / f"build_split_{tag}"
    _build.library()
    g = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for x_shape, w_shape, stride in CALLS:
        x = torch.randn(x_shape, generator=g, device="cuda").to(torch.bfloat16)
        w = (torch.randn(w_shape, generator=g, device="cuda") * 0.05).to(torch.bfloat16)

        def call():
            return k8.fp8_conv(x, w, None, None, stride, (1, 1, 1, 1), torch.float8_e5m2)

        for _ in range(2):
            call()
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(5)]
        torch.cuda.synchronize()
        for start, end in events:
            start.record()
            call()
            end.record()
        torch.cuda.synchronize()
        ms = statistics.median(start.elapsed_time(end) for start, end in events)
        out.append(f"{x_shape[1]}² {x_shape[3]}->{w_shape[0]} s{stride} {ms:.3f} ms")
        del x
        torch.cuda.empty_cache()
    print(f"{name}: " + "; ".join(out), flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 1:
        run(sys.argv[1])
    else:
        for variant in VARIANTS:
            done = subprocess.run([sys.executable, __file__, variant], cwd=REPO)
            if done.returncode != 0:
                sys.exit(done.returncode)
