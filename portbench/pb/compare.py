"""The numbers that decide ``correct``, each held to its limit.

Training: each step's loss against the reference's (the first step's
relative gap, and the largest of the three), and the gap between the
program's norm and the reference's of the first step's gradient as the
optimizer takes it and of the parameters' change over three steps, each
against the reference's norm of that leaf or of the median leaf, whichever
is larger: the worst leaf's gap and the median leaf's.
Leaves whose reference gradient is under a thousandth of the median leaf's
(a conv bias before an InstanceNorm, which the norm cancels) take a
gradient of round-off alone and are left out of both.

Serving: for every pixel of the served masks, how far the reference's logit
of the served class lies below the reference's best at the pixel the
nearest resize reads (0 where they agree), the widest gap over the sample.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# Leaves whose reference gradient norm is under this share of the median
# leaf's are left out of the change.
STILL_LEAF = 1e-3


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.to(torch.float64))) for k, v in tensors.items()}


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep: Sequence[str]) -> Dict[str, float]:
    """Each leaf's |norm_prog - norm_ref| / max(norm_ref, the median leaf's
    norm_ref), over the leaves ``keep``."""
    p, r = _norms({k: prog[k] for k in keep}), _norms({k: ref[k] for k in keep})
    median = statistics.median(r.values())
    return {k: abs(p[k] - r[k]) / max(r[k], median, 1e-30) for k in keep}


def moving_leaves(raw_grad: Dict[str, torch.Tensor]) -> List[str]:
    norms = _norms(raw_grad)
    median = statistics.median(norms.values())
    return [k for k, v in norms.items() if v >= STILL_LEAF * median]


def train_numbers(prog: Dict, ref: Dict, params0: Dict[str, torch.Tensor]) -> Dict:
    """``prog``: {"losses", "grad1", "params"} of the program's first three
    steps; ``ref``: ``reference.unet.train_steps``'s output from the same
    start ``params0``. The gradient's and the change's gaps are given by the
    worst leaf and by the median leaf (steady from seed to seed)."""
    losses = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"])]
    moving = moving_leaves(ref["raw_grad1"])
    grad = leaf_gaps(prog["grad1"], ref["grad1"], moving)
    change = leaf_gaps({k: prog["params"][k].to(torch.float32) - params0[k] for k in moving},
                       {k: ref["params"][k] - params0[k] for k in moving}, moving)
    worst_grad, worst_change = max(grad, key=grad.get), max(change, key=change.get)
    return {"loss1_gap": losses[0], "loss_gap": max(losses),
            "grad_gap": statistics.median(grad.values()), "grad_gap_worst": grad[worst_grad],
            "change_gap": statistics.median(change.values()),
            "change_gap_worst": change[worst_change],
            "detail": {"loss_gaps": losses, "grad_leaf": worst_grad, "change_leaf": worst_change,
                       "still_leaves": len(ref["grad1"]) - len(moving),
                       "losses_prog": prog["losses"], "losses_ref": ref["losses"]}}


def mask_gap(masks: Sequence[np.ndarray], sizes: Sequence[Tuple[int, int]],
             ref_logits: torch.Tensor, counts: Optional[Dict] = None) -> float:
    """Served masks (each (h, w) uint8 at its original size) against the
    reference's logits (B, S, S, C) of the same images: the widest gap by
    which the logit of a served class lies below the best logit at the
    pixel the nearest resize reads. A mask of the wrong size, or a class
    outside [0, C), reads infinity. ``counts`` (optional) gathers the pixels
    compared and those whose served class is not the reference's best."""
    from reference.unet import nearest_index

    s, c = ref_logits.shape[1], ref_logits.shape[-1]
    dev = ref_logits.device
    worst = 0.0
    for i, (mask, (h, w)) in enumerate(zip(masks, sizes)):
        if mask.shape != (h, w) or int(mask.max(initial=0)) >= c:
            return float("inf")
        rows, cols = nearest_index(s, h, dev), nearest_index(s, w, dev)
        logits = ref_logits[i][rows][:, cols]
        served = torch.from_numpy(np.ascontiguousarray(mask)).to(dev).long()
        gap = logits.max(-1).values - logits.gather(-1, served[..., None])[..., 0]
        worst = max(worst, float(gap.max()))
        if counts is not None:
            counts["pixels"] = counts.get("pixels", 0) + gap.numel()
            counts["differ"] = counts.get("differ", 0) + int((gap > 0).sum())
    return worst


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict]:
    """(every number within its limit, {name: {"value", "limit"}})."""
    checks = {k: {"value": float(numbers[k]), "limit": float(v)} for k, v in limits.items()}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
