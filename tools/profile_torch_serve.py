#!/usr/bin/env python
"""Where the PyTorch port's serving step, or its training step, spends its
time, on one CUDA card.

    python tools/profile_torch_serve.py [--batch 8] [--iters 5] [--out artifacts/profile_serve.json]
    python tools/profile_torch_serve.py --train [--batch 8] [--iters 3] [--out artifacts/profile_train.json]

Full-width ModelConfig() in fp32 (TF32 off, facevae_tpu_torch.numerics) with
seeded random weights.  Reports, for a batch of --batch frames:
  - serving: ms per encode_source / drive_frame / frontalize_frame (host
    clock around work that ends in torch.cuda.synchronize, median of
    --iters); ms per net inside drive_frame (CUDA events from forward hooks);
  - training (--train): ms per full G+D step (median of --iters after two
    warm-up steps) and the peak memory;
  - top kernels by device time over --iters drive_frame calls or training
    steps (torch.profiler), grouped into convolution / warp kernels / other,
    and the device's busy share of that window.
Writes the numbers as JSON to --out.  Fails without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402


def _median_ms(fn, iters):
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _kind(name):
    n = name.lower()
    if "warp_fwd_kernel" in n:
        return "warp kernel (csrc/warp_fwd.cu)"
    if "warp_bwd_dgrid_kernel" in n or "warp_bwd_dx_kernel" in n:
        return "warp backward kernels (csrc/warp_bwd.cu)"
    # cuDNN's own engines (wgrad_alg*, dgrad_engine, fft / DSE, the FFT
    # convolutions' complex pointwise products) and cuBLAS / CUTLASS GEMMs
    if any(s in n for s in ("conv", "cudnn", "xmma", "implicit", "winograd", "fft",
                            "gemm", "sgemm", "cutlass", "wgrad", "dgrad",
                            "pointwise_mult_and_sum_complex")):
        return "convolution / matmul"
    return "other (elementwise, norm, pooling, copies, reductions)"


def _device_profile(fn, iters):
    """Kernels by device time per call of fn over ``iters`` calls
    (torch.profiler), their sums by kind, and the device's busy share of
    the window's host time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0 and getattr(ev, "device_type", None) != torch.autograd.DeviceType.CPU:
            kernels.append((ev.key, dev_us / 1e3 / iters, ev.count // iters))
    kernels.sort(key=lambda k: -k[1])
    by_kind = defaultdict(float)
    for name, ms, _ in kernels:
        by_kind[_kind(name)] += ms
    return kernels, by_kind, sum(by_kind.values()) / (wall_us / 1e3 / iters)


def profile_train(args, card):
    from facevae_tpu_torch.config import Config
    from facevae_tpu_torch.train import create_train_state, train_step
    out_path = args.out or "artifacts/profile_train.json"
    dev = torch.device("cuda")
    cfg = Config()
    size = cfg.model.image_size
    torch.cuda.reset_peak_memory_stats(dev)
    state = create_train_state(cfg, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    batch = tuple(torch.rand(args.batch, size, size, 3, generator=g, device=dev)
                  for _ in range(4))
    for _ in range(2):                                   # cuDNN algorithm choice
        train_step(state, batch, generator=g)
    step_ms = _median_ms(lambda: train_step(state, batch, generator=g), args.iters)
    kernels, by_kind, busy_share = _device_profile(
        lambda: train_step(state, batch, generator=g), args.iters)
    report = {"card": card, "batch": args.batch, "config": "ModelConfig() fp32, TF32 off",
              "step_ms": step_ms, "frames_per_s": args.batch / step_ms * 1e3,
              "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
              "step_device_ms_by_kind": dict(by_kind), "step_device_busy_share": busy_share,
              "top_kernels": [{"name": n, "ms": ms, "calls": c} for n, ms, c in kernels[:40]]}
    print(f"{card}; training step, batch {args.batch}, ModelConfig() fp32, TF32 off: "
          f"{step_ms:.1f} ms ({report['frames_per_s']:.3f} frames/s), peak memory "
          f"{report['peak_memory_gib']:.2f} GiB")
    for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"  device {k:55s} {v:9.2f} ms")
    print(f"  device busy share of the step: {busy_share:.3f}")
    for n, ms, c in kernels[:40]:
        print(f"  {ms:9.3f} ms  x{c:<4d} {n[:110]}")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(report, f, indent=1)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--out", default=None)
    p.add_argument("--train", action="store_true", help="profile the training step")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    if args.train:
        return profile_train(args, card)
    from facevae_tpu_torch.config import Config
    from facevae_tpu_torch.models import build_models
    from facevae_tpu_torch.train.inference import InferencePipeline
    args.out = args.out or "artifacts/profile_serve.json"
    dev = torch.device("cuda")
    cfg = Config()
    models = build_models(cfg.model, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(0))
    pipe = InferencePipeline(cfg, models)
    g = torch.Generator(device=dev).manual_seed(1)
    size = cfg.model.image_size
    s = torch.rand(args.batch, size, size, 3, generator=g, device=dev)
    d = torch.rand(args.batch, size, size, 3, generator=g, device=dev)
    enc = pipe.encode_source(s)
    for _ in range(2):                                   # cuDNN algorithm choice
        pipe.drive_frame(*enc, d)
        pipe.frontalize_frame(d)
    torch.cuda.synchronize()

    graphs = {"encode_source": lambda: pipe.encode_source(s),
              "drive_frame": lambda: pipe.drive_frame(*enc, d),
              "frontalize_frame": lambda: pipe.frontalize_frame(d)}
    graph_ms = {k: _median_ms(fn, args.iters) for k, fn in graphs.items()}

    net_ms = defaultdict(float)
    events = []
    hooks = []
    for name, m in models.items():
        def pre(mod, inp, name=name):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            events.append([name, e, None])

        def post(mod, inp, out):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            events[-1][2] = e
        hooks += [m.register_forward_pre_hook(pre), m.register_forward_hook(post)]
    for _ in range(args.iters):
        pipe.drive_frame(*enc, d)
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    for name, a, b in events:
        net_ms[name] += a.elapsed_time(b) / args.iters

    kernels, by_kind, busy_share = _device_profile(lambda: pipe.drive_frame(*enc, d), args.iters)
    report = {"card": card, "batch": args.batch, "config": "ModelConfig() fp32, TF32 off",
              "graph_ms": graph_ms, "drive_frame_net_ms": dict(net_ms),
              "drive_frame_device_ms_by_kind": dict(by_kind),
              "drive_frame_device_busy_share": busy_share,
              "top_kernels": [{"name": n, "ms": ms, "calls": c} for n, ms, c in kernels[:25]]}
    print(f"{card}; batch {args.batch}, ModelConfig() fp32, TF32 off")
    for k, v in graph_ms.items():
        print(f"  {k:18s} {v:9.2f} ms/batch  ({args.batch / v * 1e3:.2f} frames/s)")
    for k, v in sorted(net_ms.items(), key=lambda kv: -kv[1]):
        print(f"  drive_frame {k:10s} {v:9.2f} ms")
    for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"  device {k:55s} {v:9.2f} ms")
    print(f"  device busy share of drive_frame: {report['drive_frame_device_busy_share']:.3f}")
    for n, ms, c in kernels[:25]:
        print(f"  {ms:9.3f} ms  x{c:<4d} {n[:110]}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
