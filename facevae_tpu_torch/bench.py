"""Training throughput of the port on one GPU (counterpart of the root
bench.py):

    python -m facevae_tpu_torch.bench [batch] [steps] [dtype] [remat]

runs the full G+D step of ModelConfig(compute_dtype=dtype) (256x256, K=15,
D=16, C=32) on seeded random weights, teachers and images, with TF32 off,
and prints one JSON line: {"metric": "train_frames_per_sec_per_chip",
"config", "dtype", "value", "unit", "card", ...}.  dtype is float32 (the
default) or bfloat16 (the conv stacks in bf16, parameters and optimizer
state fp32).  A fourth argument "remat" rematerializes
(train/objective.py); off by default, as in the root bench.  Defaults:
batch 8, 10 timed steps after 2 warm-up steps.
There is no CPU fallback: it needs a CUDA device.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

from facevae_tpu_torch.config import Config, ModelConfig
from facevae_tpu_torch.ops import fast_warp
from facevae_tpu_torch.train import create_train_state, train_step
from facevae_tpu_torch.train.objective import compute_dtype


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def run(batch_size: int = 8, steps: int = 10, dtype: str = "float32",
        warmup: int = 2, remat: bool = False) -> dict:
    """Train ``warmup`` + ``steps`` steps on the card; returns the timings,
    peak memory, the last step's losses, the warp launches of the timed
    steps and the dtypes the parameters and the Adam state hold after
    them."""
    if not torch.cuda.is_available():
        raise RuntimeError("the training bench measures a CUDA device; none is available")
    device = torch.device("cuda")
    cfg = Config(model=ModelConfig(compute_dtype=dtype, remat=remat))
    compute_dtype(cfg)                                   # refuses an unknown dtype
    size = cfg.model.image_size
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    state = create_train_state(cfg, device=device)
    g = torch.Generator(device=device).manual_seed(0)
    batch = tuple(torch.rand(batch_size, size, size, 3, generator=g, device=device)
                  for _ in range(4))
    torch.cuda.synchronize(device)
    build_s = time.perf_counter() - t0
    for _ in range(warmup):
        train_step(state, batch, generator=g)
    torch.cuda.synchronize(device)
    fast_warp.reset_launch_counts()
    step_ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        out = train_step(state, batch, generator=g)
        torch.cuda.synchronize(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = dict(fast_warp.launches)
    losses = {k: float(v) for k, v in {**out["losses_g"], **out["losses_d"]}.items()}
    adam = [v for opt in (state.g_opt, state.d_opt) for st in opt.state.values()
            for v in st.values() if v.dim() > 0]
    return {"config": f"{size}x{size} full model, batch {batch_size}, {dtype}"
                      + (", remat" if remat else ""),
            "dtype": dtype, "remat": remat, "batch": batch_size, "steps": steps, "step_ms": step_ms,
            "step_ms_median": statistics.median(step_ms),
            "frames_per_s": batch_size * steps / (sum(step_ms) / 1e3),
            "peak_memory_bytes": torch.cuda.max_memory_allocated(device),
            "build_s": build_s, "losses": losses, "launches": launches,
            "param_dtypes": sorted({str(p.dtype) for m in state.nets.values()
                                    for p in m.parameters()}),
            "adam_dtypes": sorted({str(v.dtype) for v in adam})}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    batch_size = int(argv[0]) if len(argv) > 0 else 8
    steps = int(argv[1]) if len(argv) > 1 else 10
    dtype = argv[2] if len(argv) > 2 else "float32"
    remat = (argv[3] == "remat") if len(argv) > 3 else False
    r = run(batch_size, steps, dtype, remat=remat)
    bad = [k for k, v in r["losses"].items() if v != v or abs(v) == float("inf")]
    if bad:
        raise SystemExit(f"non-finite losses {bad}: {r['losses']}")
    print(json.dumps({
        "metric": "train_frames_per_sec_per_chip", "config": r["config"], "dtype": r["dtype"],
        "remat": r["remat"],
        "value": r["frames_per_s"], "unit": "frames/s",
        "card": card_line(), "device": torch.cuda.get_device_name(0),
        "step_ms_median": r["step_ms_median"],
        "peak_memory_gib": r["peak_memory_bytes"] / 2 ** 30}))


if __name__ == "__main__":
    main()
