#!/usr/bin/env python
"""Smoke test of the PyTorch port (facevae_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each fatal on failure (exit code 1, no result line):
  1. device   nvidia-smi name and power limit, torch / CUDA versions, the
              numerics switches (TF32 off).
  2. build    nvcc-builds every kernel library from csrc/, one nvcc per
              source, all started together.
  3. kernels  each kernel against its plain PyTorch version on the card, at
              the main paths' shapes (batch 8: MFE x[8,16,64,64,4] K1=15,
              Generator x[8,16,64,64,32] K1=1), fp32 and bf16, with
              far-out-of-volume, +-inf, last-index and exact-integer
              coordinates: the warp forward, and the backward's dgrid and
              dx kernels.  Median CUDA-event times of the kernel, its plain
              version and F.grid_sample's forward / backward (a yardstick the
              port never calls) over 20 runs after a warm-up, each kernel's
              bound from its bytes, and the dx kernel's run-to-run max
              difference (its atomics add in varying order).
  4. golden   the port's encode_source / drive_frame / frontalize_frame at
              tiny_config on the card, with the JAX weights and outputs of
              tests/data/torch_golden_tiny.npz (tools/make_torch_golden.py).
  5. serve    the full-width ModelConfig() in fp32 (seeded random weights)
              behind the port's HTTP server on 127.0.0.1: 2 sessions, rounds
              of 16 concurrent /drive requests in full batches of 8, one
              /frontalize; every answer 200 and 256*256*3 bytes; the warp
              kernel launched exactly twice per batch (MFE + Generator) and
              its plain version never.  Prints p50/p95 latency and frames/s.
  6. train_tiny  one tiny_config() training step on the card against the
              same step of the port on the CPU (plain versions), from the
              same seeded weights, images and TPS parameters: every loss and
              the gradient of every G and D parameter, held to the CPU step
              as tests/test_torch_train.py holds the port to JAX.
  7. train    the full-width ModelConfig() training step, fp32, batch 8,
              seeded weights and teachers, through facevae_tpu_torch.bench:
              2 warm-up and 5 timed steps; every loss finite; per step the
              warp forward and both backward kernels launched exactly twice
              (MFE + Generator), their plain versions never.  Prints the
              step time, frames/s and peak memory.
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
KERNELS = {   # name -> (source, the TPU kernel it replaces)
    "warp_fwd": ("facevae_tpu_torch/csrc/warp_fwd.cu",
                 "facevae_tpu/ops/pallas/warp_mm.py:132"),     # _fwd_multi_kernel
    "warp_bwd_dgrid": ("facevae_tpu_torch/csrc/warp_bwd.cu",
                       "facevae_tpu/ops/pallas/warp_mm.py:192"),  # _dgrid_multi_kernel
    "warp_bwd_dx": ("facevae_tpu_torch/csrc/warp_bwd.cu",
                    "facevae_tpu/ops/pallas/warp_mm.py:247"),     # _drows_multi_kernel
}
SITES = (("MFE", 4, 15), ("Generator", 32, 1))      # call site, C, K1 at batch 8
HBM_BYTES_PER_S = 3.35e12         # H100 SXM
FP32_FLOPS = 67e12                # H100 SXM, fp32 outside the tensor cores
# kernel vs plain limits, relative to max|plain|: the forward and dgrid
# differ only in the order of their fp32 sums (dgrid reads the same bf16
# values as fp32 in both); dx sums with atomics in varying order (fp32) and
# rounds each output to bf16 once (bf16)
KERNEL_TOL = {"warp_fwd": {"float32": 1e-5, "bfloat16": 1e-2},
              "warp_bwd_dgrid": {"float32": 1e-5, "bfloat16": 1e-5},
              "warp_bwd_dx": {"float32": 1e-5, "bfloat16": 1e-2}}
# card vs CPU training step: as tests/test_torch_train.py, within SPREAD x
# the CPU step's own change under inputs nudged by NUDGE, plus these
TRAIN_TOL = {"loss": 1e-4, "grad": 1e-3, "grad_floor": 1e-2}
SPREAD, NUDGE = 10.0, 2.0 ** -20
TRAIN_STEPS, TRAIN_WARMUP = 5, 2
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
    kernels.load_all()
    for name in kernels.LIBRARIES:
        info = kernels.build_info[name]
        print(f"[build] {name} built in {info['seconds']:.2f} s")
        regs = [ln.strip() for ln in info["ptxas"].splitlines() if "registers" in ln]
        spills = [ln for ln in info["ptxas"].splitlines()
                  if "spill" in ln and not ln.strip().startswith("0 bytes stack frame, 0")]
        print(f"[build]   {len(regs)} entry points; {regs[0] if regs else ''}; "
              f"{len(spills)} with spills")
    print(f"[build] all libraries in {time.perf_counter() - t0:.2f} s (in parallel)")


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


def _bound_ms(name, N, D, H, W, C, K1, item):
    """Least time for the kernel's work on an H100: each input read once and
    each output written once over 3.35 TB/s, against its fp32 operations
    (8 corners x (C multiply-adds + weights) per sample) over 67 TFLOP/s."""
    NV = D * H * W
    vol, coords, samples = N * NV * C * item, 3 * N * K1 * NV * 4, N * NV * K1 * C * item
    nbytes = {"warp_fwd": vol + coords + samples,
              "warp_bwd_dgrid": vol + coords + samples + 3 * N * K1 * NV * 4,
              "warp_bwd_dx": coords + samples + N * NV * C * 4}[name]
    flops = N * K1 * NV * 8 * (2 * C + 12)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _library_calls(x, coords, gout):
    """F.grid_sample (3D, bilinear, zeros, align_corners=True) on the same
    samples, NCDHW with the source repeated per grid: forward, and its
    backward for the grid alone and for the source alone."""
    import torch
    import torch.nn.functional as F
    N, D, H, W, C = x.shape
    K1 = coords[0].shape[1]
    src = (x.float().permute(0, 4, 1, 2, 3)[:, None].expand(N, K1, C, D, H, W)
           .reshape(N * K1, C, D, H, W).contiguous().requires_grad_())
    grid = torch.stack([torch.nan_to_num(c, posinf=1e6, neginf=-1e6) * (2.0 / (s - 1)) - 1.0
                        for c, s in zip(coords, (W, H, D))], -1)
    grid = grid.reshape(N * K1, D, H, W, 3).requires_grad_()
    g = (gout.float().reshape(N, D, H, W, K1, C).permute(0, 4, 5, 1, 2, 3)
         .reshape(N * K1, C, D, H, W).contiguous())
    out = F.grid_sample(src, grid, mode="bilinear", padding_mode="zeros", align_corners=True)

    @torch.no_grad()
    def fwd():
        return F.grid_sample(src, grid, mode="bilinear", padding_mode="zeros",
                             align_corners=True)

    return {"warp_fwd": fwd,
            "warp_bwd_dgrid": lambda: torch.autograd.grad(out, grid, g, retain_graph=True),
            "warp_bwd_dx": lambda: torch.autograd.grad(out, src, g, retain_graph=True)}


def phase_kernels():
    import torch
    from facevae_tpu_torch.ops import fast_warp as fw
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    N, D, H, W = 8, 16, 64, 64
    for site, C, K1 in SITES:
        coords = _coords(N, K1, D, H, W, g)
        spatial = (D, H, W)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            x = torch.randn(N, D, H, W, C, generator=g, device="cuda").to(dtype)
            gout = torch.randn(N, D, H, W, K1 * C, generator=g, device="cuda").to(dtype)
            calls = {
                "warp_fwd": (lambda: fw.warp_multi_pixel_cuda(x, *coords, spatial),
                             lambda: fw.warp_multi_pixel_plain(x, *coords, spatial)),
                "warp_bwd_dgrid": (
                    lambda: fw.warp_multi_pixel_bwd_cuda(x, *coords, gout, spatial, False)[1],
                    lambda: fw.warp_multi_pixel_bwd_plain(x, *coords, gout, spatial, False)[1]),
                "warp_bwd_dx": (
                    lambda: fw.warp_multi_pixel_bwd_cuda(x, *coords, gout, spatial,
                                                         need_dgrid=False)[0],
                    lambda: fw.warp_multi_pixel_bwd_plain(x, *coords, gout, spatial,
                                                          need_dgrid=False)[0])}
            library = _library_calls(x, coords, gout) if dtype == torch.float32 else {}
            for name, (kernel, plain) in calls.items():
                out, ref = kernel(), plain()
                torch.cuda.synchronize()
                out = out if isinstance(out, tuple) else (out,)
                ref = ref if isinstance(ref, tuple) else (ref,)
                check(all(bool(torch.isfinite(o).all()) for o in out),
                      f"{name} {site} {dname}: non-finite output")
                check(all(o.shape == r.shape for o, r in zip(out, ref)),
                      f"{name} {site} {dname}: shapes {[tuple(o.shape) for o in out]}")
                err = max((o.float() - r.float()).abs().max().item() for o, r in zip(out, ref))
                scale = max(r.float().abs().max().item() for r in ref)
                row = dict(name=name, site=site, dtype=dname, C=C, K1=K1, err=err, scale=scale,
                           tol=KERNEL_TOL[name][dname] * scale, ms=cuda_ms(kernel),
                           plain_ms=cuda_ms(plain),
                           library_ms=cuda_ms(library[name]) if name in library else None)
                row["bound_ms"], row["bound_by"] = _bound_ms(name, N, D, H, W, C, K1,
                                                             x.element_size())
                if name == "warp_bwd_dx":
                    row["rerun_diff"] = (kernel().float() - out[0].float()).abs().max().item()
                rows.append(row)
                lib = "" if row["library_ms"] is None else f", F.grid_sample {row['library_ms']:.4f}"
                rerun = (f"; run-to-run max|diff| {row['rerun_diff']:.3e}"
                         if "rerun_diff" in row else "")
                print(f"[kernels] {name} {site} x[{N},{D},{H},{W},{C}] K1={K1} {dname}: "
                      f"max|err| {err:.3e} (limit {row['tol']:.3e}, max|ref| {scale:.3f}); "
                      f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f}{lib}, "
                      f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}){rerun}")
    for r in rows:
        check(r["err"] <= r["tol"], f"{r['name']} {r['site']} {r['dtype']}: "
                                    f"{r['err']:.3e} > {r['tol']:.3e}")
    return rows


def _golden_pipeline(device, z):
    from facevae_tpu_torch.config import tiny_config
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
    from facevae_tpu_torch.config import Config
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
    return counts


def _held(actual, ref, nudged, rel, scale=None):
    """(err, limit) of the card's value against the CPU step's: limit =
    SPREAD x the CPU step's own change under nudged inputs + rel x scale."""
    actual, ref, nudged = (t.detach().double().cpu() for t in (actual, ref, nudged))
    err = (actual - ref).abs().max().item()
    scale = ref.abs().max().item() if scale is None else scale
    return err, SPREAD * (nudged - ref).abs().max().item() + rel * scale


def _ratio(err, lim):
    return err / lim if lim > 0 else (0.0 if err == 0 else float("inf"))


def phase_train_tiny():
    """One tiny_config() step on the card against the port's CPU step."""
    import copy
    import numpy as np
    import torch
    from facevae_tpu_torch.config import tiny_config
    from facevae_tpu_torch.models import D_MODEL_NAMES, G_MODEL_NAMES
    from facevae_tpu_torch.ops import fast_warp
    from facevae_tpu_torch.ops.tps import TransformParams, random_transform_params
    from facevae_tpu_torch.train import build_all_modules, create_train_state, train_step
    cfg = tiny_config()
    weights = {k: copy.deepcopy(m.state_dict())
               for k, m in build_all_modules(cfg, "cpu").items()}
    rs = np.random.RandomState(0)
    batch = [rs.rand(2, 64, 64, 3).astype(np.float32) for _ in range(4)]
    nudged = [(b * (1 + NUDGE * rs.randn(*b.shape))).astype(np.float32) for b in batch]
    tp = random_transform_params(torch.Generator().manual_seed(0), 2)

    def step(device, images):
        nets = build_all_modules(cfg, device)
        for k, m in nets.items():
            m.load_state_dict(weights[k])
        state = create_train_state(cfg, device, nets)
        out = train_step(state, [torch.from_numpy(b).to(device) for b in images],
                         transform_params=TransformParams(*(t.to(device) for t in tp)))
        grads = {n: {k: p.grad for k, p in state.nets[n].named_parameters()}
                 for n in G_MODEL_NAMES + D_MODEL_NAMES}
        return {**out["losses_g"], **out["losses_d"]}, grads

    fast_warp.reset_launch_counts()
    card_losses, card_grads = step("cuda", batch)
    torch.cuda.synchronize()
    launches = dict(fast_warp.launches)
    (cpu_losses, cpu_grads), (nud_losses, nud_grads) = step("cpu", batch), step("cpu", nudged)
    bad, worst = [], 0.0
    for k, v in card_losses.items():
        err, lim = _held(v, cpu_losses[k], nud_losses[k], TRAIN_TOL["loss"])
        worst = max(worst, _ratio(err, lim))
        if not err <= lim:
            bad.append(f"loss {k}: {err:.3e} > {lim:.3e}")
    for n, grads in card_grads.items():
        top = max(g.abs().max().item() for g in cpu_grads[n].values())
        for k, gr in grads.items():
            ref = cpu_grads[n][k]
            err, lim = _held(gr, ref, nud_grads[n][k], TRAIN_TOL["grad"],
                             max(ref.abs().max().item(), TRAIN_TOL["grad_floor"] * top))
            worst = max(worst, _ratio(err, lim))
            if not err <= lim:
                bad.append(f"{n}.{k} grad: {err:.3e} > {lim:.3e}")
    print(f"[train_tiny] card vs CPU step, tiny_config batch 2: losses "
          + ", ".join(f"{k} {float(v):.5f}/{float(cpu_losses[k]):.5f}"
                      for k, v in card_losses.items()))
    print(f"[train_tiny] {sum(len(g) for g in card_grads.values())} gradient leaves and "
          f"{len(card_losses)} losses held; worst err/limit {worst:.3f}; card launches {launches}")
    check(not bad, f"card step differs from the CPU step: {bad[:8]}")
    check(launches == {"warp_fwd": 2, "warp_fwd_plain": 0, "warp_bwd_dgrid": 2,
                       "warp_bwd_dgrid_plain": 0, "warp_bwd_dx": 2, "warp_bwd_dx_plain": 0},
          f"tiny step launches {launches}")


def phase_train(card):
    """The full-width training step through the bench's function."""
    from facevae_tpu_torch import bench
    r = bench.run(batch_size=8, steps=TRAIN_STEPS, warmup=TRAIN_WARMUP)
    bad = [k for k, v in r["losses"].items() if not abs(v) < float("inf")]
    check(not bad, f"non-finite losses {bad}: {r['losses']}")
    n = TRAIN_STEPS
    want = {"warp_fwd": 2 * n, "warp_fwd_plain": 0, "warp_bwd_dgrid": 2 * n,
            "warp_bwd_dgrid_plain": 0, "warp_bwd_dx": 2 * n, "warp_bwd_dx_plain": 0}
    check(r["launches"] == want, f"{n} training steps launched {r['launches']}, want {want}")
    print(f"[train] {card}: {r['config']}: step {r['step_ms_median']:.1f} ms median "
          f"({', '.join(f'{t:.1f}' for t in r['step_ms'])}), {r['frames_per_s']:.3f} frames/s, "
          f"peak memory {r['peak_memory_bytes'] / 2 ** 30:.2f} GiB, "
          f"build + state {r['build_s']:.1f} s")
    print(f"[train] losses {json.dumps({k: round(v, 5) for k, v in r['losses'].items()})}; "
          f"warp launches over {n} steps {r['launches']}")
    return r["launches"]


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
    phase_s = {}
    try:
        card = phase_device()
        for name, fn in (("build", phase_build), ("kernels", phase_kernels),
                         ("golden", phase_golden), ("serve", lambda: phase_serve(card)),
                         ("train_tiny", phase_train_tiny), ("train", lambda: phase_train(card))):
            t0 = time.perf_counter()
            out = fn()
            phase_s[name] = round(time.perf_counter() - t0, 1)
            if name == "kernels":
                rows = out
            elif name == "serve":
                serve_launches = out
            elif name == "train":
                train_launches = out
    except PhaseError as e:
        print(f"FAIL: {e}", flush=True)
        return 1
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        fp32 = [r for r in rows if r["name"] == name and r["dtype"] == "float32"]
        # one step's calls of the kernel: the MFE site + the Generator site (fp32)
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": train_launches[name],
            "launches_by_path": {"serve": serve_launches.get(name, 0),
                                 "train": train_launches[name]},
            "max_abs_err": max(r["err"] for r in fp32),
            "ms": sum(r["ms"] for r in fp32), "plain_ms": sum(r["plain_ms"] for r in fp32),
            "bound_ms": sum(r["bound_ms"] for r in fp32), "bound_by": fp32[0]["bound_by"],
            "library_ms": sum(r["library_ms"] for r in fp32)})
    print(json.dumps({"kernels": kernels}))
    print(f"[done] {time.perf_counter() - t_all:.1f} s; phases {json.dumps(phase_s)}")
    print(smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
