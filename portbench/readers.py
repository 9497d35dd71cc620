"""What the per-layer metrics' readers share.  Each metric is a file
portbench/metrics/<name>.py with ``read(ctx) -> float | None``; a reader
that finds nothing to read returns None, and the metric is left out of the
line.  ``ctx`` is run.py's Context: the cell's kind ("train" or "serve"),
its configuration, the profiled slice (or None) and the cell driver's facts."""
from __future__ import annotations

import json
import os
import re
from typing import Optional

from portbench import roofline, trace

_HERE = os.path.dirname(os.path.abspath(__file__))


def idle_share(ctx, kind: str) -> Optional[float]:
    if ctx.kind != kind or ctx.slice is None:
        return None
    v = ctx.slice.idle_share()
    return None if v is None else 100.0 * v


def launches_per_unit(ctx, kind: str) -> Optional[float]:
    if ctx.kind != kind or ctx.slice is None or not ctx.slice.units:
        return None
    return ctx.slice.host_calls(trace.launch_calls()) / ctx.slice.units


def conv_roofline(ctx, kind: str) -> Optional[float]:
    if ctx.kind != kind or ctx.slice is None:
        return None
    ops = ctx.slice.conv_ops()
    if not ops:
        return None
    p = roofline.peaks()
    share = roofline.conv_share(ops, ctx.conv_item, p["flops_per_s"][ctx.conv_peak],
                                p["bytes_per_s"])
    return None if share is None else 100.0 * share


def warp_roofline(ctx, kind: str) -> Optional[float]:
    """The warp kernels' least time over their device time in the slice:
    each warp kernel that started in the slice is matched by its name to
    its site (warp_sites/<config>.<kind>.json: the call sites and shapes
    the configuration implies), whose bound it counts once.  Nothing when a
    warp kernel of warp_kernels.json ran that no site names (the path
    changed under the file)."""
    if ctx.kind != kind or ctx.slice is None:
        return None
    path = os.path.join(_HERE, "warp_sites", f"{ctx.config['name']}.{kind}.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        sites = json.load(f)["sites"]
    with open(os.path.join(_HERE, "warp_kernels.json")) as f:
        names = json.load(f)
    p = roofline.peaks()
    bound = {s["kernel"]: roofline.warp_least_s([dict(s, launches=1)],
                                                p["flops_per_s"]["float32"], p["bytes_per_s"])
             for s in sites}
    least = busy = 0.0
    for a, b, name in ctx.slice.kernels(names):
        site = [k for k in bound if re.search(r"\b" + re.escape(k) + r"\b", name)]
        if len(site) != 1:
            return None
        least += bound[site[0]]
        busy += b - a
    return 100.0 * least / busy if busy > 0 else None


def mfu(ctx, kind: str) -> Optional[float]:
    """Model operations a unit (the reference's count) x units of the
    window outside the slice / that time / the configuration's peak."""
    f = ctx.facts
    if ctx.kind != kind or not f.get("flops_per_unit") or not f.get("window_units"):
        return None
    rate = f["flops_per_unit"] * f["window_units"] / f["window_s"]
    return 100.0 * rate / roofline.peaks()["flops_per_s"][ctx.conv_peak]

