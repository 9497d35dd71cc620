"""Profiled slices of a run, read in memory: the device's busy
intervals, the host's launch calls, the convolutions with their shapes and
device time, the kernels by name, and the idle gaps by the CUDA call the
host was in.  Nothing is written to disk.

A slice is two profiles of a few steps or drive batches after the window:
a light one (CUDA activity only: kernels, copies and the runtime calls,
so the host keeps its pace) for the busy and idle shares, the launches,
the kernels' times and the breakdown, and a heavy one (host operators with
their shapes) for the convolutions' shapes.  The light slice runs from its
first device operation's start to its last one's end.
"""
from __future__ import annotations

import bisect
import json
import os
import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

_HERE = os.path.dirname(os.path.abspath(__file__))


def _load(name):
    with open(os.path.join(_HERE, name)) as f:
        return json.load(f)


def union_length(intervals: List[Tuple[float, float]], lo: float = None,
                 hi: float = None) -> float:
    """Total length covered by the intervals, clipped to [lo, hi]."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if lo is not None:
            a = max(a, lo)
        if hi is not None:
            b = min(b, hi)
        if b <= a:
            continue
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def merged(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _activity(e) -> str:
    """The kineto activity type's name ("kernel", "gpu_memcpy",
    "gpu_user_annotation", "cpu_op", ...), or "" where it is not given."""
    try:
        return str(e.activity_type()).lower()
    except (AttributeError, RuntimeError):
        return ""


def _on_device(e) -> bool:
    from torch.autograd import DeviceType
    return e.device_type() == DeviceType.CUDA


def _device_time_us(evt) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


class Slice:
    """What one profiled slice holds.  Times in seconds."""

    def __init__(self, light, heavy, units: int):
        self.units = units                       # steps or drive batches of the light slice
        self.device, self.host = [], []          # (start, end, name)
        for e in light.profiler.kineto_results.events():
            if "annotation" in _activity(e):
                continue
            a, b = e.start_ns() * 1e-9, e.end_ns() * 1e-9
            (self.device if _on_device(e) else self.host).append((a, b, e.name()))
        self.lo = min((a for a, _, _ in self.device), default=0.0)
        self.hi = max((b for _, b, _ in self.device), default=0.0)
        self.functions = heavy.events() if heavy is not None else []

    # -- the device ------------------------------------------------------
    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    @property
    def busy_s(self) -> float:
        return union_length([(a, b) for a, b, _ in self.device], self.lo, self.hi)

    def idle_share(self) -> Optional[float]:
        if self.window_s <= 0 or not self.device:
            return None
        return 1.0 - self.busy_s / self.window_s

    def kernels(self, names: List[str]) -> List[Tuple[float, float, str]]:
        """Device operations that started in the slice and whose name holds
        one of ``names`` as a word."""
        pat = re.compile(r"\b(" + "|".join(map(re.escape, names)) + r")\b")
        return [d for d in self.device if pat.search(d[2]) and self.lo <= d[0] <= self.hi]

    # -- the host ----------------------------------------------------------
    def host_calls(self, names: List[str]) -> int:
        """Runtime calls of the light slice named in ``names``."""
        want = set(names)
        return sum(1 for _, _, n in self.host if n in want)

    def conv_ops(self) -> List[Tuple[str, list, list, float]]:
        """(name, input shapes, concrete inputs, device seconds) of every
        outermost aten::convolution / aten::convolution_backward of the
        heavy profile."""
        names = ("aten::convolution", "aten::convolution_backward")
        out = []
        for e in self.functions:
            if e.name not in names:
                continue
            parent, nested = e.cpu_parent, False
            while parent is not None:
                if parent.name in names:
                    nested = True
                    break
                parent = parent.cpu_parent
            if not nested:
                out.append((e.name, e.input_shapes, list(getattr(e, "concrete_inputs", []) or []),
                            _device_time_us(e) * 1e-6))
        return out

    # -- the breakdown -----------------------------------------------------
    def breakdown(self, top: int = 10) -> Dict[str, list]:
        by_op = defaultdict(float)
        for a, b, n in self.device:
            by_op[n[:160]] += max(0.0, min(b, self.hi) - max(a, self.lo))
        busy = merged([(max(a, self.lo), min(b, self.hi)) for a, b, _ in self.device
                       if b > self.lo and a < self.hi])
        gaps, t = [], self.lo
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if t < self.hi:
            gaps.append((t, self.hi))
        host = sorted(self.host)
        starts = [h[0] for h in host]
        by_gap = defaultdict(float)
        for a, b in gaps:
            mid = 0.5 * (a + b)
            # the shortest runtime call running at the gap's midpoint
            i = bisect.bisect_right(starts, mid)
            best = None
            for h in host[max(0, i - 256):i]:
                if h[1] >= mid and (best is None or h[1] - h[0] < best[1] - best[0]):
                    best = h
            label = best[2][:150] if best else "no CUDA call (Python, dispatch)"
            by_gap["host: " + label] += b - a
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        idle = sorted(by_gap.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in idle]}


def launch_calls() -> List[str]:
    """The CUDA runtime and driver calls that launch device work."""
    return _load("launch_calls.json")


def light_profile(is_cuda: bool):
    """A profiler of CUDA activity alone (on a CPU run: host operators)."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA if is_cuda else ProfilerActivity.CPU])


def heavy_profile(is_cuda: bool):
    """A profiler of host operators with their shapes, and the device."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if is_cuda else [])
    return profile(activities=acts, record_shapes=True)
