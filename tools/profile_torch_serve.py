#!/usr/bin/env python
"""Where the PyTorch port's serving step, its training step or its training
loop spends its time, on one CUDA card.

    python tools/profile_torch_serve.py [--batch 8] [--iters 5] [--out artifacts/profile_serve.json]
    python tools/profile_torch_serve.py --train [--dtype bfloat16] [--batch 8] [--iters 3] [--out ...]
    python tools/profile_torch_serve.py --loop [--dtype bfloat16] [--steps 16] [--epochs 3] [--out ...]

Full-width ModelConfig() (TF32 off, facevae_tpu_torch.numerics) with seeded
random weights; serving runs fp32, training --dtype (float32, the default,
or bfloat16).  Reports, for a batch of --batch frames:
  - serving: ms per encode_source / drive_frame / frontalize_frame (host
    clock around work that ends in torch.cuda.synchronize, median of
    --iters); ms per net inside drive_frame (CUDA events from forward hooks);
  - training (--train): ms per full G+D step (median of --iters after two
    warm-up steps) and the peak memory;
  - top kernels by device time over --iters drive_frame calls or training
    steps (torch.profiler), grouped into convolution / warp kernels / other,
    and the device's busy share of that window;
  - the loop (--loop): the training CLI (facevae_tpu_torch.train's main)
    in-process over a PNG tree PIL writes (4 identities x 2 clips x 6
    frames at 256², with grain), --steps steps an epoch for --epochs
    epochs, three times: with an epoch file saved every epoch (each written
    by a background thread while the next epoch trains), with none, and
    with none and the frame cache (--device_cache: no loader threads); per
    epoch the seconds per step, frames/s (the epoch line's), the loop's
    wait on the prefetch queue, the visualization and snapshot seconds;
    the device's busy share of steps 10-14 (--profile_dir's window, in the
    run without epoch files: the trace's export lengthens epoch 0); and
    the bench's step time (facevae_tpu_torch.bench, 2 warm-up and 5 timed
    steps) in the same process.
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
    if any(k in n for k in ("grid_fwd_kernel", "grid_dgrid_kernel", "grid_dx_kernel")):
        return "single-grid warp kernels (csrc/warp_grid.cu)"
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
    from facevae_tpu_torch.config import Config, ModelConfig
    from facevae_tpu_torch.train import create_train_state, train_step
    out_path = args.out or f"artifacts/profile_train_{args.dtype}.json"
    dev = torch.device("cuda")
    cfg = Config(model=ModelConfig(compute_dtype=args.dtype))
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
    config = f"ModelConfig() {args.dtype}, TF32 off"
    report = {"card": card, "batch": args.batch, "config": config,
              "step_ms": step_ms, "frames_per_s": args.batch / step_ms * 1e3,
              "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
              "step_device_ms_by_kind": dict(by_kind), "step_device_busy_share": busy_share,
              "top_kernels": [{"name": n, "ms": ms, "calls": c} for n, ms, c in kernels[:40]]}
    print(f"{card}; training step, batch {args.batch}, {config}: "
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


def profile_loop(args, card):
    import gc
    import tempfile
    from PIL import Image
    from facevae_tpu_torch import bench
    from facevae_tpu_torch.data.synthetic import write_training_tree
    from facevae_tpu_torch.train import cli
    out_path = args.out or f"artifacts/profile_loop_{args.dtype}.json"
    ids, clips, frames = 4, 2, 6
    r = bench.run(batch_size=args.batch, steps=5, warmup=2, dtype=args.dtype)
    report = {"card": card, "dtype": args.dtype, "batch": args.batch,
              "steps_per_epoch": args.steps, "bench_step_ms": r["step_ms_median"], "runs": {}}
    print(f"{card}; bench: {r['step_ms_median']:.1f} ms a step ({args.dtype}, batch "
          f"{args.batch})")
    del r
    with tempfile.TemporaryDirectory() as tmp:
        root = write_training_tree(f"{tmp}/data", 256, ids, clips, frames,
                                   write=lambda p, img: Image.fromarray(img).save(p), noise=8)
        none = args.epochs + 1
        for tag, freq, extra in (("an epoch file every epoch", 1, []),
                                 ("no epoch file", none, []),
                                 ("no epoch file, frame cache", none, ["--device_cache", "true"])):
            gc.collect()
            torch.cuda.empty_cache()
            run = f"{tmp}/{len(report['runs'])}"
            argv = ["--root_dir", root, "--batch_size", str(args.batch), "--num_repeats",
                    str(args.steps * args.batch // ids), "--num_epochs", str(args.epochs),
                    "--checkpoint_freq", str(freq), "--keep_checkpoints", "1",
                    "--remat", "false", "--bf16", str(args.dtype == "bfloat16"),
                    "--ckp_dir", f"{run}/ckp", "--vis_dir", f"{run}/vis",
                    "--log_file", f"{run}/log.txt", *extra]
            if tag == "no epoch file":   # the trace's export lengthens its epoch
                argv += ["--profile_dir", f"{run}/trace"]
            _, records = cli.main(argv)
            report["runs"][tag] = records
            for e in records:
                steps = args.steps
                print(f"  {tag}: epoch {e['epoch']}: {e['steps_s'] / steps * 1e3:.1f} ms a step "
                      f"over {steps} steps, {e['frames_per_s']:.3f} frames/s (epoch line), "
                      f"prefetch wait {e['wait_s']:.3f} s ({e['wait_s'] / e['steps_s']:.1%}), "
                      f"vis {e['vis_s']:.2f} s, ckpt-snap {e['ckpt_s']:.2f} s")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(report, f, indent=1)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--out", default=None)
    p.add_argument("--train", action="store_true", help="profile the training step")
    p.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"),
                   help="the training step's compute_dtype")
    p.add_argument("--loop", action="store_true", help="profile the training loop")
    p.add_argument("--steps", type=int, default=16, help="--loop: steps an epoch")
    p.add_argument("--epochs", type=int, default=3, help="--loop: epochs a run")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    if args.train:
        return profile_train(args, card)
    if args.loop:
        return profile_loop(args, card)
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
