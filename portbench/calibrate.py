"""Readings for the limits of a cell's check (not run by the benchmark's
own runs):

    python3 -m portbench.calibrate --workload train-fp32 --seeds 1,2,3 \
        --control-seeds 1,2,3 --out readings/calibrate-train-fp32.json

For every seed, one sound run of the program against the reference (the
lower readings); for every control seed also the control (the reference at
the configuration's lower precision, in the program's place), each fault
the cell can have planted in the reference put in the program's place,
and a second fp32 reference (the reference's own spread).  Writes every
number to --out and prints a summary.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from portbench import checks, run as runmod
from portbench import serve_reference as sr
from portbench import train_reference as tr


def train_controls(config, cell, seed, device, res):
    """The control, the half-batch fault, a second reference, and a state
    left unchanged (read without a run), each against the reference."""
    ref = res["readings"]["reference"]
    row = {}
    for name, kw in (("control", {"precision": config["lower_precision"]}),
                     ("half_batch", {"fault": "half_batch"}),
                     ("reference_again", {})):
        row[name] = checks.train_numbers(tr.run(config, cell["traffic"], seed, device, **kw), ref)
    row["unchanged"] = checks.train_numbers(
        {"losses": ref["losses"], "grad": [0.0] * len(ref["grad"]),
         "change": [0.0] * len(ref["change"]), "buffers": [0.0] * len(ref["buffers"])}, ref)
    return row


def serve_controls(config, cell, seed, device, res):
    """The control (the reference at the lower precision in the program's
    place, for the same requests) and two faults planted in it: each answer
    replaced by another request's, and each answer mirrored."""
    rd = res["readings"]
    ref = rd["reference"]["frames"]
    keys = [k for k, _ in rd["kept_rows"]] + [k for k, _ in rd["answers"]]
    low, _ = sr.frames_for(config, seed, device, rd["sources"], rd["driving"], keys,
                           precision=config["lower_precision"])
    order = sorted(set(keys))
    other = {k: ref[order[(i + 1) % len(order)]] for i, k in enumerate(order)}

    def as_run(frames):
        return ([(k, frames[k]) for k, _ in rd["kept_rows"]],
                [(k, sr.as_bytes(frames[k])) for k, _ in rd["answers"]])

    return {"control": sr.numbers(*as_run(low), ref),
            "other_answer": sr.numbers(*as_run(other), ref),
            "mirrored": sr.numbers(*as_run({k: v[:, ::-1] for k, v in ref.items()}), ref)}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=0.01)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    runmod.set_cache_dirs()
    import torch
    if not torch.cuda.is_available():
        sys.exit("calibration reads the card; none is available")
    device = torch.device("cuda", 0)
    cell, config = runmod.cell_files(args.workload)
    driver = __import__(f"portbench.drivers.{cell['driver']}", fromlist=["run"])
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    out = {"workload": args.workload, "card": runmod.card_line(), "runs": []}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    for seed in seeds:
        t = time.perf_counter()
        res = driver.run(config, cell, seed, args.seconds, False, device)
        row = {"seed": seed, "program": res["numbers"], "seconds": time.perf_counter() - t}
        if seed in control:
            row.update((train_controls if cell["driver"] == "train" else serve_controls)(
                config, cell, seed, device, res))
        out["runs"].append(row)
        print(json.dumps(row), flush=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    keys = sorted({k for r in out["runs"] for k in r["program"]})
    for k in keys:
        lows = [r["program"][k] for r in out["runs"]]
        print(f"{k}: program max {max(lows):.3e} over {len(lows)} seeds", end="")
        for name in ("control", "half_batch", "reference_again", "unchanged", "other_answer",
                     "mirrored"):
            v = [r[name][k] for r in out["runs"] if name in r]
            if v:
                print(f"; {name} min {min(v):.3e}", end="")
        print()


if __name__ == "__main__":
    main()
