"""The numbers that decide `correct`, and how each is read.

A training cell compares the program's first CHECK_STEPS steps with the
reference's from the same weights, frames and generator states:

  first_loss_gap     the first step's loss terms: the worst term's
                     |program - reference| over max(|reference term|, the
                     median |term|)
  first_grad_gap     the first step's gradient, leaf by leaf (the program's
                     as its Adam state holds it after one step, exp_avg /
                     (1 - beta1); the reference's p.grad): the worst leaf's
                     | ||g_p|| - ||g_r|| | over max(||g_r||, the median
                     leaf's ||g_r||)
  change_gap_median  the parameters' change over the steps, leaf by leaf,
                     the same way, read at the median leaf; leaves whose
                     reference gradient is under a thousandth of the median
                     leaf's are left out (Adam moves them by round-off)
  first_buffer_gap   the change of the BatchNorm running statistics and the
                     spectral-norm u, v in the first step, the worst leaf's
                     gap the same way

Why the first step, and the median leaf over the steps: with seeded
random weights the step is chaotic.  Two fp32 runs of the reference itself, the same seed and
inputs, agree bit for bit in the first step's losses, yet their losses in
the third step differ by up to 0.2 and single leaves' changes by up to 0.6
(round-off of atomics and cuDNN's algorithms, grown through two Adam
steps in the keypoint-driven losses), so a later step's loss or the worst
leaf's change cannot tell the program from a fault.  A state left
unchanged, or changed twice, reads about 1 at the median leaf.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

SMALL_GRADIENT = 1e-3


def _median(values: Sequence[float]) -> float:
    v = sorted(values)
    return v[len(v) // 2] if v else 0.0


def _gaps(program: Sequence[float], reference: Sequence[float],
          keep: Sequence[bool] = None) -> List[float]:
    """Each kept entry's |p - r| / max(|r|, median |r|); inf for a NaN."""
    med = _median([abs(r) for r in reference])
    out = []
    for i, (p, r) in enumerate(zip(program, reference)):
        if keep is not None and not keep[i]:
            continue
        den = max(abs(r), med)
        gap = abs(p - r) / den if den > 0 else (0.0 if p == r else float("inf"))
        out.append(float("inf") if gap != gap else gap)
    return out


def norm_gap(program: Sequence[float], reference: Sequence[float],
             keep: Sequence[bool] = None) -> float:
    """The worst entry's gap: for leaves' norms, | ||p|| - ||r|| | over
    max(||r||, the median leaf's); for loss terms the same with |r|."""
    return max(_gaps(program, reference, keep), default=0.0)


def median_gap(program: Sequence[float], reference: Sequence[float],
               keep: Sequence[bool] = None) -> float:
    """The median leaf's gap, as norm_gap measures it."""
    gaps = _gaps(program, reference, keep)
    return _median(gaps) if gaps else float("inf")


def large_gradients(grad_norms: Sequence[float]) -> List[bool]:
    """The leaves whose gradient is at least SMALL_GRADIENT of the median leaf's."""
    med = _median(grad_norms)
    return [g >= SMALL_GRADIENT * med for g in grad_norms]


def train_numbers(program: Dict, reference: Dict) -> Dict[str, float]:
    """program / reference: {"losses": [steps][terms], "grad": [leaves],
    "change": [leaves], "buffers": [leaves]} (norms as floats; grad and
    buffers of the first step, change over the steps)."""
    keep = large_gradients(reference["grad"])
    return {"first_loss_gap": norm_gap(program["losses"][0], reference["losses"][0]),
            "first_grad_gap": norm_gap(program["grad"], reference["grad"]),
            "change_gap_median": median_gap(program["change"], reference["change"], keep),
            "first_buffer_gap": norm_gap(program["buffers"], reference["buffers"])}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True when every number with a limit is within it (a missing number,
    or a NaN, fails; so does a cell without limits)."""
    return bool(limits) and all(k in numbers and numbers[k] <= v for k, v in limits.items())


@torch.no_grad()
def leaf_norms(tensors: List[torch.Tensor]) -> List[float]:
    """fp32 L2 norms of a list of tensors, read in one copy to the host."""
    if not tensors:
        return []
    return torch.stack(torch._foreach_norm([t.float() for t in tensors])).tolist()


@torch.no_grad()
def change_norms(after: List[torch.Tensor], before: List[torch.Tensor]) -> List[float]:
    return leaf_norms(torch._foreach_sub([a.float() for a in after],
                                         [b.float() for b in before]))
