"""What the four probe modules share: the wrappers' device dispatch and
tensor checks, timing, bounds, and the entry points' device argument.
Nothing here runs at import time."""
from __future__ import annotations

import argparse
import statistics
import subprocess
import time

import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM
FP32_FLOPS = 67e12                 # H100 SXM, fp32 outside the tensor cores


def on_cuda(op, t):
    """True for a CUDA tensor, False for a CPU one; raises for any other."""
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{op} runs on cuda or cpu, not {t.device}")
    return t.device.type == "cuda"


def stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def check_tensor(op, name, t, dtype, device, shape=None):
    """What a kernel wrapper demands of each tensor it passes by pointer."""
    if t.device != device:
        raise ValueError(f"{op}: {name} lies on {t.device}, not {device}")
    if t.dtype != dtype:
        raise TypeError(f"{op}: {name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{op}: {name} must be {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{op}: {name} must be contiguous")


def graph_ms(fn, runs=20, warmup=3, reps=10):
    """Time per call of fn() on the device, in ms: ``reps`` calls captured
    back to back in one CUDA graph, the median CUDA-event time of ``runs``
    replays, divided by reps.  No host Python runs inside the timed window
    (at these probes' sizes it takes longer than the kernels), and one
    replay's own launch is spread over reps calls.  A kernel's wrapper
    counts the reps captured launches."""
    for _ in range(warmup):           # also builds the kernels before capture
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def host_ms(fn, runs=20, warmup=1):
    """Median host time of fn() in ms (the CPU runs of the probes)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def timer(device):
    return graph_ms if torch.device(device).type == "cuda" else host_ms


def bound_ms(nbytes, flops=0):
    """The least time an H100 takes for a kernel that moves nbytes through
    its memory and does flops fp32 operations: (ms, "bytes" or
    "operations", whichever bounds it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def parser(doc):
    p = argparse.ArgumentParser(description=doc.split("\n\n")[0],
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels, CUDA-event times) or cpu (the plain "
                        "versions, host times)")
    return p


def device(name):
    """The entry points' device: the card unless the caller asks for the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the probes run their kernels on the card "
                         "(pass --device cpu for the plain versions on the CPU)")
    return dev


def card(dev):
    """The line every printed time is read beside."""
    if dev.type != "cuda":
        return "CPU: plain versions, host times (no device metric)"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def time_label(dev):
    return "device ms per call, CUDA graph" if dev.type == "cuda" else "host ms"
