"""The benchmark's arithmetic of least times: the card's peaks, a
convolution's operations and bytes from its shapes, and the warp kernels'
bounds (a copy of chip_smoke.py:_bound_ms's arithmetic).  A roofline share
is the least time, the larger of operations over the peak rate and bytes
over the memory bandwidth, over the measured device time."""
from __future__ import annotations

import json
import math
import os
from typing import List, Optional, Sequence

_HERE = os.path.dirname(os.path.abspath(__file__))


def peaks() -> dict:
    with open(os.path.join(_HERE, "peaks.json")) as f:
        return json.load(f)


def least_s(flops: float, nbytes: float, flops_per_s: float, bytes_per_s: float) -> float:
    return max(flops / flops_per_s, nbytes / bytes_per_s)


# -- convolutions --------------------------------------------------------

def _out_size(n, k, s, p, d):
    return (n + 2 * p - d * (k - 1) - 1) // s + 1


def conv_work(name: str, shapes: Sequence, concrete: Sequence, item: int):
    """(flops, bytes) of one aten::convolution or aten::convolution_backward
    as the profiler records it (input shapes and the constant arguments).
    Operations are those of the direct convolution, 2 per multiply-add;
    bytes read each input once and write each output once, at ``item``
    bytes a value.  None where the record lacks the shapes."""
    if name == "aten::convolution":
        x, w = shapes[0], shapes[1]
        if not x or not w:
            return None
        stride, padding, dilation, transposed, _, groups = concrete[3:9]
        bias = shapes[2] if len(shapes) > 2 and shapes[2] else []
        mask = (True, True, False)
        grad_out = None
    elif name == "aten::convolution_backward":
        grad_out, x, w = shapes[0], shapes[1], shapes[2]
        if not x or not w or not grad_out:
            return None
        stride, padding, dilation, transposed, _, groups, mask = concrete[4:11]
        bias = []
    else:
        return None
    dims = len(x) - 2
    stride, padding, dilation = (
        [int(v) for v in (a if isinstance(a, (list, tuple)) else [a] * dims)]
        for a in (stride, padding, dilation))
    groups = int(groups)
    if transposed:
        return None                       # no transposed convolution on the paths measured
    n, cin, cout = x[0], x[1], w[0]
    out = ([_out_size(x[2 + i], w[2 + i], stride[i], padding[i], dilation[i])
            for i in range(dims)] if grad_out is None else list(grad_out[2:]))
    macs = n * cout * math.prod(out) * (cin // groups) * math.prod(w[2:])
    xs, ws = math.prod(x), math.prod(w)
    if grad_out is None:
        ys = n * cout * math.prod(out)
        return 2.0 * macs, float(xs + ws + sum(bias[:1]) + ys) * item
    gs = math.prod(grad_out)
    need_x, need_w = bool(mask[0]), bool(mask[1])
    flops = 2.0 * macs * (need_x + need_w)
    nbytes = gs + (ws + xs if need_x else 0) + (xs + ws if need_w else 0)
    return flops, float(nbytes) * item


def conv_share(ops, item: int, flops_per_s: float, bytes_per_s: float) -> Optional[float]:
    """Sum of the convolutions' least times over their device time."""
    least, busy = 0.0, 0.0
    for name, shapes, concrete, dev_s in ops:
        work = conv_work(name, shapes, concrete, item)
        if work is None:
            return None
        least += least_s(work[0], work[1], flops_per_s, bytes_per_s)
        busy += dev_s
    return least / busy if busy > 0 else None


# -- warp kernels ----------------------------------------------------------

def warp_work(half: str, N: int, D: int, H: int, W: int, C: int, K1: int, item: int):
    """(flops, bytes) of one warp kernel launch, chip_smoke.py:_bound_ms's
    arithmetic: each input read once and each output written once, against
    8 corners x (C multiply-adds + weights) per sample."""
    NV = D * H * W
    vol, coords, samples = N * NV * C * item, 3 * N * K1 * NV * 4, N * NV * K1 * C * item
    nbytes = {"fwd": vol + coords + samples,
              "bwd_dgrid": vol + coords + samples + 3 * N * K1 * NV * 4,
              "bwd_dx": coords + samples + N * NV * C * 4}[half]
    flops = N * K1 * NV * 8 * (2 * C + 12)
    return float(flops), float(nbytes)


def warp_least_s(sites: List[dict], fp32_flops_per_s: float, bytes_per_s: float) -> float:
    """Least seconds of one unit's warp launches (sites: one entry per
    launch kind with its shapes and launches per unit)."""
    total = 0.0
    for s in sites:
        f, b = warp_work(s["half"], *s["shape"], s["K1"], s["item"])
        total += s["launches"] * least_s(f, b, fp32_flops_per_s, bytes_per_s)
    return total
