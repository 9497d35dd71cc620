"""Where a cell's traced slice goes, by the program's own spans (not run by
the benchmark's own runs; PERF.md §5 gives its readings):

    python3 -m portbench.span_report --workload serve-fp32-c16 --seed 1 \
        --out spans-serve.json

One traced run of the cell (run.py's, on the first card); prints its result
line and writes it to --out with: the host ms of each span name that lies in
the light slice, and of those that ended before it (the window and set-up,
without a profiler; median and count), the light slice's idle seconds by the
innermost span of the thread that holds the step or flush spans, and the
heavy slice's device ms under each outermost ``net.*`` and
``remat.recompute.*`` range and under the innermost span of each host event.
"""
from __future__ import annotations

import argparse
import collections
import json
import statistics
import sys

from portbench import run as runmod
from portbench import spans as sp

NAMES = ("train.", "serve.", "remat.", "net.")


def device_ms_innermost(functions) -> dict:
    """The heavy slice's device ms by the innermost program span around each
    host event that launched work ("none": outside every span, such as the
    backward's operations on autograd's thread outside a recompute)."""
    out = collections.defaultdict(float)
    for e in functions:
        us = sp.own_device_us(e) if sp._is_cpu_op(e) else 0.0
        if us <= 0:
            continue
        op, owner = e, "none"
        while op is not None:
            if op.name.startswith(NAMES):
                owner = op.name
                break
            op = op.cpu_parent
        out[owner] += us / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def report(name: str, line: dict, s, ring) -> dict:
    rep = {"workload": name, "card": runmod.card_line(), "line": line,
           "window_s": s.window_s, "busy_s": s.busy_s, "units": s.units}
    host, before = collections.defaultdict(list), collections.defaultdict(list)
    for x in ring:
        a, b = sp.seconds(x)
        if a >= s.lo and b <= s.hi:
            host[x.name].append((x.end_ns - x.start_ns) / 1e6)
        elif b < s.lo:
            before[x.name].append((x.end_ns - x.start_ns) / 1e6)
    for key, by_name in (("host_ms", host), ("host_ms_before", before)):
        rep[key] = {k: {"median": statistics.median(v), "count": len(v)}
                    for k, v in sorted(by_name.items())}
    top = "train.step" if name.startswith("train") else "serve.flush"
    threads = collections.Counter(x.thread for x in ring if x.name == top)
    if threads:
        rep["idle_s_by_innermost"] = sp.idle_by_innermost(
            [(a, b) for a, b, _ in s.device], s.lo, s.hi, ring, threads.most_common(1)[0][0])
    for prefix in ("net.", "remat.recompute."):
        under, total = sp.device_us_under(s.functions, prefix)
        rep[f"device_ms_outermost_{prefix}"] = {k: v / 1e3 for k, v in sorted(under.items())}
        rep["heavy_device_ms"] = total / 1e3
    rep["device_ms_innermost"] = device_ms_innermost(s.functions)
    return rep


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    started = runmod.process_start()
    runmod.set_cache_dirs()
    import torch
    if not torch.cuda.is_available():
        sys.exit("the report reads the card's slice; no card is available")
    line, res = runmod.run_cell(args.workload, args.seed, args.seconds, True,
                                torch.device("cuda", 0), started=started)
    print(json.dumps(line), flush=True)
    s = res["slice"]
    from facevae_tpu_torch import tracing
    rep = report(args.workload, line, s, tracing.spans(hi_ns=int(s.hi * 1e9)))
    with open(args.out, "w") as f:
        json.dump(rep, f, indent=1)
    print(json.dumps({k: v for k, v in rep.items() if k != "line"}), file=sys.stderr)


if __name__ == "__main__":
    main()
