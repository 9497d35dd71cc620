"""Run one cell of the benchmark once:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell is workloads/<cell>.json, its
configuration configs/<config>.json, its driver drivers/<driver>.py; the
metrics a line carries are those BENCHMARK.json gives the cell: with
--trace 0 its end-to-end metrics, with --trace 1 its per-layer metrics,
each read by metrics/<name>.py.  The last line of standard output is one
JSON object (correct, attempted, failed, metrics, device, breakdown with
--trace 1, then checks: each number compared with its limit); the numbers
compared are also the last lines of standard error.

It measures facevae_tpu_torch on CUDA cards and nothing else: without
enough cards, without the program, or with a JAX module loaded once the
window has closed, it prints no result and exits with a code other than 0.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time

from portbench import checks

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def process_start() -> float:
    """This process's start on the wall clock (Linux /proc)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")


def set_cache_dirs(root: str = ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout.
    The program builds its own kernels under facevae_tpu_torch/_build/."""
    cache = os.path.join(root, "portbench", ".cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(cache, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_files(name: str, root: str = ROOT):
    """(cell, config) of workloads/<name>.json and the config it names."""
    cell = load_json(root, "portbench", "workloads", f"{name}.json")
    config = load_json(root, "portbench", "configs", f"{cell['config']}.json")
    return cell, config


def manifest_metrics(manifest: dict, name: str):
    """The end-to-end and per-layer metric entries BENCHMARK.json gives cell
    ``name``."""
    e2e = [m for m in manifest["end_to_end"] if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if name in m.get("workloads", [name]) and m["moves"] in names]
    return e2e, per_layer


def read_metric(name: str, ctx):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


class Context:
    """What a metric reader sees."""

    def __init__(self, kind, config, slice_, facts):
        self.kind, self.config, self.slice, self.facts = kind, config, slice_, facts
        self.conv_peak = config["conv_peak"]
        self.conv_item = {"float32": 4, "bfloat16": 2}[config["compute_dtype"]]


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip().splitlines()
        return out[0] if out else "nvidia-smi gave nothing"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e!r}"


def fail(msg: str, code: int):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             cell: dict = None, config: dict = None, manifest: dict = None, plant=None,
             started: float = None):
    """Everything of a run but the look for cards and the JAX check: the
    cell driver's run, the metrics BENCHMARK.json gives the cell, and the
    verdict.  Returns (result line, the cell driver's result).  ``started`` is
    the process's start (setup_s runs from it to the window's start);
    ``plant`` (tests only) breaks the program's timed path underneath."""
    started = time.time() if started is None else started
    if cell is None:
        cell, config = cell_files(name)
    manifest = manifest if manifest is not None else load_json(ROOT, "BENCHMARK.json")
    e2e_entries, layer_entries = manifest_metrics(manifest, name)
    driver = importlib.import_module(f"portbench.drivers.{cell['driver']}")
    res = driver.run(config, cell, seed, seconds, bool(trace), device=device, plant=plant)
    values = dict(res["e2e"], setup_s=res["window_start"] - started)
    if trace:
        ctx = Context(cell["driver"], config, res.get("slice"), dict(res["facts"]))
        metrics = {}
        for m in layer_entries:
            v = read_metric(m["name"], ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                   for m in e2e_entries if values.get(m["name"]) is not None}
    limits = cell.get("limits", {})
    numbers = res["numbers"]
    correct = checks.verdict(numbers, limits)
    if cell["driver"] == "train":
        correct = correct and res["failed"] == 0
    is_cuda = torch_device_type(device) == "cuda"
    device_info = {"platform": "gpu" if is_cuda else "cpu",
                   "kind": __import__("torch").cuda.get_device_name(0) if is_cuda else "cpu",
                   "count": cell["chips"],
                   "memory_peak_bytes": int(res.get("memory_peak_bytes", 0))}
    line = {"correct": correct, "attempted": int(res["attempted"]),
            "failed": int(res["failed"]), "metrics": metrics, "device": device_info}
    if trace and res.get("slice") is not None:
        s = res["slice"]
        device_info["busy_s"], device_info["window_s"] = s.busy_s, s.window_s
        line["breakdown"] = s.breakdown()
    line["checks"] = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    return line, res


def torch_device_type(device) -> str:
    return getattr(device, "type", str(device).split(":")[0])


def main(argv=None):
    started = process_start()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    set_cache_dirs()
    cell, config = cell_files(args.workload)
    try:
        import facevae_tpu_torch  # noqa: F401  the program under test
    except ImportError as e:
        fail(f"the program facevae_tpu_torch is not here: {e!r}", 2)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        fail(f"cell {args.workload} needs {cell['chips']} CUDA card(s); "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found", 3)
    line, res = run_cell(args.workload, args.seed, args.seconds, args.trace,
                         torch.device("cuda", 0), cell, config, started=started)
    found = __import__("portbench.jaxcheck", fromlist=["forbidden"]).forbidden()
    if found:
        fail(f"JAX modules loaded in the benchmark's process: {found}", 4)
    print(f"portbench: card {card_line()}; {json.dumps(res.get('notes', {}))}", file=sys.stderr)
    for k, v in line["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
