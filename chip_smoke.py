#!/usr/bin/env python
"""Smoke test of the PyTorch port (facevae_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each fatal on failure (exit code 1, no result line):
  1. device   nvidia-smi name and power limit, torch / CUDA versions, the
              numerics switches (TF32 off).
  2. build    nvcc-builds every kernel of the serving path from csrc/.
  3. kernels  each kernel against its plain PyTorch version on the card, at
              the serving path's shapes (batch 8), fp32 and bf16, with
              far-out-of-volume and exact-integer coordinates; median
              CUDA-event times of both over 20 runs after a warm-up.
  4. golden   the port's encode_source / drive_frame / frontalize_frame at
              tiny_config on the card, with the JAX weights and outputs of
              tests/data/torch_golden_tiny.npz (tools/make_torch_golden.py).
  5. serve    the full-width ModelConfig() in fp32 (seeded random weights)
              behind the port's HTTP server on 127.0.0.1: 2 sessions, rounds
              of 16 concurrent /drive requests in full batches of 8, one
              /frontalize; every answer 200 and 256*256*3 bytes; the warp
              kernel launched exactly twice per batch (MFE + Generator) and
              its plain version never.  Prints p50/p95 latency and frames/s.
Then a JSON line of kernel results, the card's name and power limit, and the
last line {"ok": true, "device": {...}}.  There is no CPU fallback: without
a CUDA device the script fails.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "data" / "torch_golden_tiny.npz"
WARP_SRC = "facevae_tpu_torch/csrc/warp_fwd.cu"
WARP_REPLACES = "facevae_tpu/ops/pallas/warp_mm.py:132"   # _fwd_multi_kernel
# kernel vs plain limits, relative to max|plain|: fp32 differs only in the
# order of the 8 fp32 multiply-adds; bf16 outputs are each rounded to bf16
KERNEL_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# port vs JAX golden, relative to max|ref| (the CPU test's tolerance): fp32
# through a few conv layers, amplified by the 0.1-temperature soft-argmax
GOLDEN_TOL = 1e-4
ROUNDS, CONCURRENCY, MAX_BATCH = 4, 16, 8


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def smi():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    return out.splitlines()[0].strip()


def cuda_ms(fn, runs=20, warmup=3):
    """Median CUDA-event time of fn() in ms over ``runs`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_device():
    import torch
    from facevae_tpu_torch import numerics
    card = smi()
    print(f"[device] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    print(f"[device] numerics {numerics.apply()}")
    return card


def phase_build():
    from facevae_tpu_torch import kernels
    t0 = time.perf_counter()
    kernels.load("warp_fwd")
    info = kernels.build_info["warp_fwd"]
    print(f"[build] warp_fwd built in {info['seconds']:.2f} s "
          f"(load total {time.perf_counter() - t0:.2f} s)")
    for line in info["ptxas"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build]   {line.strip()}")


def _coords(N, K1, D, H, W, g):
    """Pixel coordinates as a motion field makes them (an affine map of the
    grid plus noise, reaching past the border), with exact integers, the
    border values and far-out-of-volume probes mixed in."""
    import torch
    dev = "cuda"
    z, y, x = torch.meshgrid(torch.arange(D, device=dev), torch.arange(H, device=dev),
                             torch.arange(W, device=dev), indexing="ij")
    base = torch.stack([x, y, z]).reshape(3, 1, 1, -1).float()       # [3,1,1,NV]
    size = torch.tensor([W, H, D], device=dev, dtype=torch.float32).reshape(3, 1, 1, 1)
    scale = 1 + 0.2 * (torch.rand(3, N, K1, 1, generator=g, device=dev) - 0.5)
    shift = 0.2 * size * (torch.rand(3, N, K1, 1, generator=g, device=dev) - 0.5)
    noise = torch.randn(3, N, K1, base.shape[-1], generator=g, device=dev)
    c = (base - size / 2) * scale + size / 2 + shift + noise
    pick = torch.rand(c.shape, generator=g, device=dev)
    c = torch.where(pick < 0.1, torch.round(c), c)                  # exact integers
    probes = torch.tensor([-1e30, -1e6, -1.0, -0.5, 0.0, 1e-3, 1e6, 1e30,
                           float("inf"), float("-inf")], device=dev)
    idx = torch.randint(0, probes.numel(), c.shape, generator=g, device=dev)
    c = torch.where(pick > 0.995, probes[idx], c)                   # far out / border
    c = torch.where((pick > 0.99) & (pick <= 0.995), size - 1, c)   # last index
    return [c[a].contiguous() for a in range(3)]


def phase_kernels():
    import torch
    from facevae_tpu_torch.ops import fast_warp
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for site, (C, K1) in (("MFE", (4, 15)), ("Generator", (32, 1))):
        N, D, H, W = 8, 16, 64, 64
        cgx, cgy, cgz = _coords(N, K1, D, H, W, g)
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(N, D, H, W, C, generator=g, device="cuda").to(dtype)
            args = (x, cgx, cgy, cgz, (D, H, W))
            out = fast_warp.warp_multi_pixel_cuda(*args)
            ref = fast_warp.warp_multi_pixel_plain(*args)
            torch.cuda.synchronize()
            check(out.shape == ref.shape == (N, D, H, W, K1 * C) and out.dtype == dtype,
                  f"{site} {dtype}: shape {tuple(out.shape)} {out.dtype}")
            check(bool(torch.isfinite(out).all()), f"{site} {dtype}: non-finite output")
            err = (out.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            name = str(dtype).split(".")[-1]
            ms = cuda_ms(lambda: fast_warp.warp_multi_pixel_cuda(*args))
            plain_ms = cuda_ms(lambda: fast_warp.warp_multi_pixel_plain(*args))
            row = dict(site=site, dtype=name, C=C, K1=K1, err=err, scale=scale,
                       ms=ms, plain_ms=plain_ms, tol=KERNEL_TOL[name] * scale)
            rows.append(row)
            print(f"[kernels] warp_fwd {site} x[{N},{D},{H},{W},{C}] K1={K1} {name}: "
                  f"max|err| {err:.3e} (limit {row['tol']:.3e}, max|ref| {scale:.3f}); "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    for r in rows:
        check(r["err"] <= r["tol"], f"warp_fwd {r['site']} {r['dtype']}: "
                                    f"{r['err']:.3e} > {r['tol']:.3e}")
    return rows


def _golden_pipeline(device, z):
    from facevae_tpu.config import tiny_config
    from facevae_tpu_torch.convert import load_jax_variables, nested_from_flat
    from facevae_tpu_torch.models import build_models
    from facevae_tpu_torch.train.inference import InferencePipeline
    variables = nested_from_flat({k[len("var/"):]: z[k] for k in z.files
                                  if k.startswith("var/")})
    cfg = tiny_config()
    models = build_models(cfg.model, device=device)
    for name, m in models.items():
        load_jax_variables(m, variables[name])
    return InferencePipeline(cfg, models)


def phase_golden():
    import numpy as np
    import torch
    z = np.load(GOLDEN)
    pipe = _golden_pipeline(torch.device("cuda"), z)
    s = torch.from_numpy(z["in/source"]).cuda()
    d = torch.from_numpy(z["in/driving"]).cuda()
    enc = pipe.encode_source(s)
    outs = dict(zip(("fs", "kp_c", "kp_s", "Rs"), enc))
    outs["drive"] = pipe.drive_frame(*enc, d)
    outs["frontalize"] = pipe.frontalize_frame(d)
    bad = []
    for k, v in outs.items():
        ref = z["out/" + k]
        err = float(np.abs(v.cpu().numpy() - ref).max())
        lim = GOLDEN_TOL * float(np.abs(ref).max())
        print(f"[golden] {k}: max|err| {err:.3e} (limit {lim:.3e})")
        if not err <= lim:
            bad.append(k)
    check(not bad, f"port differs from the JAX golden in {bad}")


def _post(url, body, timeout=300):
    req = urllib.request.Request(url, data=body, method="POST")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as r:
        data = r.read()
        return r.status, data, time.perf_counter() - t0


def phase_serve(card):
    import numpy as np
    import torch
    from facevae_tpu.config import Config
    from facevae_tpu_torch.models import build_models
    from facevae_tpu_torch.ops import fast_warp
    from facevae_tpu_torch.serve import BatchedEngine, start_server
    from facevae_tpu_torch.train.inference import InferencePipeline

    device = torch.device("cuda")
    cfg = Config()
    size = cfg.model.image_size
    t0 = time.perf_counter()
    models = build_models(cfg.model, device=device,
                          generator=torch.Generator(device=device).manual_seed(0))
    pipe = InferencePipeline(cfg, models)
    # a window long enough that 16 concurrent requests always fill two batches
    engine = BatchedEngine(pipe, device, MAX_BATCH, window_ms=2000.0)
    engine.warmup()
    torch.cuda.synchronize()
    print(f"[serve] ModelConfig() {size}x{size} K={cfg.model.num_kp} D={cfg.model.depth} "
          f"C={cfg.model.app_channels} fp32: build + warm-up {time.perf_counter() - t0:.1f} s")
    g = torch.Generator(device=device).manual_seed(1)
    batch = torch.rand(MAX_BATCH, size, size, 3, generator=g, device=device)
    enc = pipe.encode_source(batch)

    def drive():
        pipe.drive_frame(*enc, batch)
        torch.cuda.synchronize()

    direct_ms = cuda_ms(drive, runs=5, warmup=1)
    engine.flush_ms.clear()
    server = start_server(engine, "127.0.0.1", 0)
    base = "http://127.0.0.1:%d" % server.server_address[1]
    rs = np.random.RandomState(0)
    n_bytes = size * size * 3
    try:
        fast_warp.reset_launch_counts()
        for s in ("a", "b"):
            code, body, _ = _post(f"{base}/source?session={s}",
                                  rs.randint(0, 256, n_bytes, dtype=np.uint8).tobytes())
            check(code == 200, f"/source {s}: HTTP {code} {body[:200]!r}")
        frames = [rs.randint(0, 256, n_bytes, dtype=np.uint8).tobytes()
                  for _ in range(CONCURRENCY)]
        lat, results, wall = [], [], 0.0
        for _ in range(ROUNDS):
            out = [None] * CONCURRENCY

            def go(i):
                try:
                    out[i] = _post(f"{base}/drive?session={'ab'[i % 2]}", frames[i])
                except Exception as e:                   # reported below
                    out[i] = (repr(e), b"", 0.0)

            threads = [threading.Thread(target=go, args=(i,)) for i in range(CONCURRENCY)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            wall += time.perf_counter() - t0
            results += out
            lat += [r[2] for r in out]
        for code, body, _ in results:
            check(code == 200 and len(body) == n_bytes,
                  f"/drive: HTTP {code}, {len(body)} bytes {body[:200]!r}")
        st = dict(engine.stats)
        n_drive = ROUNDS * CONCURRENCY
        check(st == {"batches": n_drive // MAX_BATCH, "frames": n_drive, "padded": 0},
              f"/drive batches not full: {st}")
        code, body, _ = _post(f"{base}/frontalize", frames[0])
        check(code == 200 and len(body) == n_bytes, f"/frontalize: HTTP {code}, {len(body)} bytes")
        counts = dict(fast_warp.launches)
        batches = engine.stats["batches"]
        print(f"[serve] engine {engine.stats}; warp launches {counts}")
        check(counts["warp_fwd"] == 2 * batches and counts["warp_fwd_plain"] == 0,
              f"warp launches {counts} for {batches} batches: expected "
              f"{2 * batches} kernel, 0 plain")
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()

    imgs = torch.from_numpy(np.stack([np.frombuffer(f, np.uint8).reshape(size, size, 3)
                                      for f in frames[:MAX_BATCH]]).astype(np.float32) / 255)
    enc = pipe.encode_source(imgs.to(device))
    gen = pipe.drive_frame(*enc, imgs.to(device))
    check(gen.shape == (MAX_BATCH, size, size, 3), f"drive_frame shape {tuple(gen.shape)}")
    check(bool(torch.isfinite(gen).all()) and 0 <= gen.min().item() and gen.max().item() <= 1,
          "drive_frame output not finite in [0, 1]")
    lat.sort()
    p50 = statistics.median(lat)
    p95 = lat[min(len(lat) - 1, int(round(0.95 * (len(lat) - 1))))]
    print(f"[serve] {card}: {n_drive} /drive requests in {ROUNDS} rounds of {CONCURRENCY} "
          f"concurrent, batch {MAX_BATCH}: p50 {p50 * 1e3:.1f} ms, p95 {p95 * 1e3:.1f} ms, "
          f"{n_drive / wall:.2f} frames/s; output std {gen.std().item():.4f}")
    print(f"[serve] drive batch of {MAX_BATCH}: {direct_ms:.1f} ms called directly, "
          f"median {statistics.median(engine.flush_ms):.1f} ms per engine flush "
          f"({len(engine.flush_ms)} flushes)")
    return counts["warp_fwd"]


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"FAIL: {e}")
        return 1
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; this smoke test needs a CUDA GPU")
        return 1
    try:
        import facevae_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"FAIL: run from the root of a checkout ({e})")
        return 1
    t_all = time.perf_counter()
    try:
        card = phase_device()
        phase_build()
        rows = phase_kernels()
        phase_golden()
        launches = phase_serve(card)
    except PhaseError as e:
        print(f"FAIL: {e}", flush=True)
        return 1
    fp32 = [r for r in rows if r["dtype"] == "float32"]
    print(json.dumps({"kernels": [{
        "name": "warp_fwd", "route": "cuda", "source": WARP_SRC,
        "replaces": WARP_REPLACES, "launches": launches,
        "max_abs_err": max(r["err"] for r in fp32),
        # one drive batch's warps: the MFE call + the Generator call (fp32)
        "ms": sum(r["ms"] for r in fp32), "plain_ms": sum(r["plain_ms"] for r in fp32)}]}))
    print(f"[done] {time.perf_counter() - t_all:.1f} s")
    print(smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
