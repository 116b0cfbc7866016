"""Times K1bwd (the InstanceNorm+LeakyReLU backward) at the shapes of a b32
train step of unet_6stage at 512² (its 22 norms, dense, and the two s2d norms),
from the checkout given as the first argument, on one CUDA card.

    python tools/k1bwd_times.py CHECKOUT LABEL

Each shape runs 20 calls by CUDA events after two warm-ups, cycling through
copies of its inputs that outgrow the L2, as `chip_smoke.py` phase 5 does. To
compare two versions, unpack each into a directory and run them in one
process sequence on one card: A, B, B, A.
"""

import os
import statistics
import sys

import torch

root = os.path.abspath(sys.argv[1])
label = sys.argv[2]
sys.path.insert(0, root)
import chip_smoke as cs  # noqa: E402
from unet_implementations_tpu_torch.kernels import instance_norm as k1  # noqa: E402

total = bound = 0.0
with torch.inference_mode():
    for level, ((side, c), calls) in enumerate(zip(cs.LEVELS, cs.K1_CALLS)):
        seed = cs.SEED + 20 + 10 * level
        inputs = [cs.k1_bwd_inputs(32, side, c, torch.bfloat16, seed=seed)]
        x = inputs[0][0]
        inputs += [cs.k1_bwd_inputs(32, side, c, torch.bfloat16, seed=seed + i)
                   for i in range(1, cs.n_copies(2 * x.numel() * x.element_size()))]
        bd = cs.k1_bwd_bound_ms(x)[0]
        t = cs.cuda_times(lambda a: k1._cuda_backward(*a, 0.01, 1), inputs, iters=20)
        ms = statistics.median(t)
        total += calls * ms
        bound += calls * bd
        print(f"{label} level {level} {tuple(x.shape)}: {cs.spread(t)} bound {bd:.4f} "
              f"({bd / ms:.1%}), {3 * x.numel() * 2 / ms / 1e6:.0f} GB/s", flush=True)
        del inputs, x
        torch.cuda.empty_cache()
    for side, c in cs.K1_S2D_NORMS:
        inputs = [cs.k1_bwd_inputs(32, side, c, torch.bfloat16, 4, seed=7)]
        x = inputs[0][0]
        bd = cs.k1_bwd_bound_ms(x, 4)[0]
        t = cs.cuda_times(lambda a: k1._cuda_backward(*a, 0.01, 4), inputs, iters=20)
        print(f"{label} s2d {tuple(x.shape)} g4: {cs.spread(t)} bound {bd:.4f} "
              f"({bd / statistics.median(t):.1%})", flush=True)
        del inputs, x
print(f"{label} K1bwd per b32 dense step: {total:.3f} ms, bound {bound:.3f} ms "
      f"({bound / total:.1%}); {torch.cuda.get_device_name(0)}")
