"""What the readers of the program's own spans share.  The program
(facevae_tpu_torch/tracing.py) keeps its spans in a ring in memory, stamped
with time.time_ns(): the Unix-epoch clock of the profiler's events, so
spans lay over a profiled slice (trace.py) as they are.  Under a profile
with CPU activity (the heavy slice) each span is also a record_function
range of its name, whose device time the profile attributes.

Every function but ``ring`` takes plain values (seconds, or the profile's
FunctionEvents), so the tests run them on synthetic slices and spans.
``ring`` returns nothing where the program keeps no spans (a program
without tracing.py), and a reader then returns None.
"""
from __future__ import annotations

import statistics
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from portbench.trace import merged

Interval = Tuple[float, float]


def ring(lo_s: float, hi_s: float) -> Optional[list]:
    """The program's spans that overlap [lo_s, hi_s] (seconds on the
    profiler's clock), or None without a span ring."""
    try:
        from facevae_tpu_torch import tracing
    except ImportError:
        return None
    return tracing.spans(int(lo_s * 1e9), int(hi_s * 1e9))


def seconds(s) -> Interval:
    return s.start_ns * 1e-9, s.end_ns * 1e-9


def durations_ms(spans: Sequence, name: str, lo: float, hi: float,
                 ends_in: bool = False) -> List[float]:
    """The durations in ms of the spans called ``name`` that lie in
    [lo, hi] (seconds), or with ``ends_in`` that end in it."""
    out = []
    for s in spans:
        a, b = seconds(s)
        if s.name == name and lo <= b <= hi and (ends_in or a >= lo):
            out.append((s.end_ns - s.start_ns) / 1e6)
    return out


def median_ms(spans: Optional[Sequence], name: str, lo: float, hi: float,
              ends_in: bool = False) -> Optional[float]:
    if not spans:
        return None
    values = durations_ms(spans, name, lo, hi, ends_in)
    return statistics.median(values) if values else None


def overlap(a: List[Interval], b: List[Interval]) -> float:
    """The length of (union of ``a``) ∩ (union of ``b``)."""
    a, b = merged(a), merged(b)
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_within(device: List[Interval], within: List[Interval], lo: float, hi: float) -> float:
    """The device's idle time inside the union of ``within``, clipped to
    [lo, hi]: that union's length less the device's busy time in it."""
    clip = [(max(a, lo), min(b, hi)) for a, b in within if min(b, hi) > max(a, lo)]
    covered = sum(b - a for a, b in merged(clip))
    return covered - overlap(device, clip)


def gaps(device: List[Interval], lo: float, hi: float) -> List[Interval]:
    """The device's idle gaps in [lo, hi]."""
    out, t = [], lo
    for a, b in merged([(max(a, lo), min(b, hi)) for a, b in device if b > lo and a < hi]):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if t < hi:
        out.append((t, hi))
    return out


def idle_by_innermost(device: List[Interval], lo: float, hi: float, spans: Sequence,
                      thread: int) -> Dict[str, float]:
    """The device's idle seconds in [lo, hi] by the innermost span of
    ``thread`` open at each gap's midpoint ("none" where no span is).  Spans
    the thread recorded for another thread's span (a request's queue wait,
    whose parent is its request) are not the thread's own and do not count."""
    ids = {s.id for s in spans if s.thread == thread}
    mine = sorted((seconds(s) + (s.name,) for s in spans
                   if s.thread == thread and (s.parent is None or s.parent in ids)),
                  key=lambda x: x[0])
    out = defaultdict(float)
    for a, b in gaps(device, lo, hi):
        mid, name = 0.5 * (a + b), "none"
        for start, end, n in mine:
            if start > mid:
                break
            if end >= mid:
                name = n            # the latest-started span open there: the innermost
        out[name] += b - a
    return dict(out)


# -- the heavy slice: device time under record_function ranges -----------------

def _is_cpu_op(e) -> bool:
    return str(e.device_type).endswith("CPU") and not e.is_async


def own_device_us(e) -> float:
    """The device time of the operations a host event launched itself: its
    ``kernels``, less any entry named as the event (a range's copy on the
    device lane, or a legacy timing of the event itself)."""
    return sum(k.duration for k in e.kernels if k.name != e.name)


def device_us_under(functions: Sequence, prefix: str) -> Tuple[Dict[str, float], float]:
    """({name: device us}, all device us) of a profile's FunctionEvents:
    each host event's own device time is charged to the outermost range
    around it, on its thread, whose name starts with ``prefix``; the total
    is all host events' own device time (kernels the profile links to no
    host event count in neither)."""
    under, total = defaultdict(float), 0.0
    for e in functions:
        if not _is_cpu_op(e):
            continue
        us = own_device_us(e)
        if us <= 0:
            continue
        total += us
        op, owner = e, None
        while op is not None:
            if op.name.startswith(prefix):
                owner = op.name
            op = op.cpu_parent
        if owner is not None:
            under[owner] += us
    return dict(under), total


def share_under(functions: Sequence, prefix: str) -> Optional[float]:
    """The share in % of a profile's device time under ``prefix`` ranges,
    None where no such range charged any."""
    under, total = device_us_under(functions, prefix)
    if not under or total <= 0:
        return None
    return 100.0 * sum(under.values()) / total
