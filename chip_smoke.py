#!/usr/bin/env python
"""Smoke test of the PyTorch port (facevae_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each fatal on failure (exit code 1, no result line):
  1. device   nvidia-smi name and power limit, torch / CUDA versions, the
              numerics switches (TF32 off).
  2. build    nvcc-builds every kernel library from csrc/ (warp_fwd,
              warp_bwd, warp_grid, probe_gather, probe_warp), one nvcc per
              source, all started together.
  3. kernels  each kernel against its plain PyTorch version on the card, at
              the main paths' shapes (batch 8), fp32 and bf16, with
              far-out-of-volume, +-inf, last-index and exact-integer
              coordinates.  The multi-grid warp (forward, dgrid, dx) at MFE
              x[8,16,64,64,4] K1=15 on three coordinate sets (the noisy
              affine set, and MFE's own sparse-motion coordinates from
              seeded keypoints and head poses, clean and with the probes:
              facevae_tpu_torch/warp_inputs.py) and Generator
              x[8,16,64,64,32] K1=1, and its forward at the bf16 TPS warp
              x[8,1,256,256,3] K1=1; the
              single-grid warp (forward, dgrid, dx) at the Generator shape
              (gps=1, a deformation-like grid) and the reference-form MFE
              shape x[8,16,64,64,4] (gps=16 grids from create_sparse_motions
              on seeded keypoints).  The device time per call of the kernel
              and of F.grid_sample's forward / backward in x's dtype (a
              yardstick the port never calls, the source repeated per grid):
              10 calls in one CUDA graph, median of 20 replays; the kernel's
              and its plain version's median CUDA-event time over 20 calls;
              each kernel's bound from its bytes, and the dx kernels'
              run-to-run max difference (their atomics add in varying
              order).  The dx kernels' deterministic variants (fixed-point
              int64 sums) at every site and dtype where dx runs: within
              the dx tolerance of the plain version, the same bits on a
              second run and, at MFE, with the K1 grids permuted; their
              device time beside the default kernel's.  Per multi-grid site
              and dtype the bytes of kernel 1's stores (through a
              shared-memory tile at K1 > 1) and of the cotangent kernel 2
              reads.  Then the single-grid forward
              against the multi-grid forward on the same samples at both
              single-grid shapes (fp32) and at the TPS frame (bf16, where
              kernel 1 runs its pixel kernel): within 1e-5 of max|ref|, and
              whether they agree bit for bit.
  4. golden   the port's encode_source / drive_frame / frontalize_frame at
              tiny_config on the card, with the JAX weights and outputs of
              tests/data/torch_golden_tiny.npz (tools/make_torch_golden.py).
  5. serve    the full-width ModelConfig() in fp32 (seeded random weights)
              behind the port's HTTP server on 127.0.0.1: 2 sessions, rounds
              of 16 concurrent /drive requests in full batches of 8, one
              /frontalize; every answer 200 and 256*256*3 bytes; per batch
              the multi-grid forward kernel once (MFE) and the single-grid
              forward kernel once (Generator), the plain versions never.
              Prints p50/p95 latency and frames/s.
  6. train_tiny  one tiny_config() training step on the card against the
              same step of the port on the CPU (plain versions), from the
              same numpy-seeded weights, images and TPS parameters, in fp32
              (the CPU step run here) and in bf16 (the CPU step recorded in
              tests/data/torch_bf16_step_tiny.npz by
              tools/make_torch_step_golden.py): every loss and the gradient
              of every G and D parameter, held to the CPU step as
              tests/test_torch_train.py (fp32) and tests/test_torch_bf16.py
              (bf16) hold the port to JAX.  Each step again under
              torch.use_deterministic_algorithms(True) (strict: an op
              without a deterministic implementation raises, and the phase
              fails): held the same way, the dx kernels' deterministic
              variants launched in place of the default ones.
  7. train    the full-width ModelConfig() training step, fp32, batch 8,
              seeded weights and teachers, through facevae_tpu_torch.bench:
              2 warm-up and 5 timed steps; every loss finite; per step each
              multi-grid kernel once (MFE) and each single-grid kernel once
              (Generator), the plain versions never.  Prints the step time,
              frames/s and peak memory.
  8. train_bf16  the same step with ModelConfig(compute_dtype="bfloat16"):
              every loss finite, parameters and Adam state fp32; per step the
              multi-grid forward 3 times (MFE, Generator, TPS), its dgrid
              and dx kernels twice, the single-grid kernels and the plain
              versions never.  Prints the step time, frames/s, peak memory.
  9. probes   the probe path: the run() of each of the four probes of
              facevae_tpu_torch/probes/ (TPU kernels 7-10, csrc/probe_*.cu)
              at the probe's own shapes, as its entry point calls it, with
              the launch counts set to 0 before and read after (each kernel
              at least once, the plain versions never); then each kernel
              against its plain version on the same inputs: the gathers bit
              for bit (all seven cases of probe 9), the warps within 1e-5 of
              max|ref|, probe 8 at theta = 3 and 40 degrees in each mode
              (bandonly only where every box fits); probe 8 against kernel 1
              on the same samples (1e-5, and whether bit for bit), its boxes
              staged where the host says they fit, and the probe's fit rates
              1.00 / 0.08.  The device's time per call of kernel, plain
              version and library call (10 calls captured in one CUDA
              graph, the median CUDA-event time of 20 replays over 10: the
              host's Python would otherwise outlast these kernels), and
              the bounds.
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
BF16_STEP_GOLDEN = ROOT / "tests" / "data" / "torch_bf16_step_tiny.npz"
KERNELS = {   # name -> (source, the TPU kernel it replaces)
    "warp_fwd": ("facevae_tpu_torch/csrc/warp_fwd.cu",
                 "facevae_tpu/ops/pallas/warp_mm.py:132"),     # _fwd_multi_kernel
    "warp_bwd_dgrid": ("facevae_tpu_torch/csrc/warp_bwd.cu",
                       "facevae_tpu/ops/pallas/warp_mm.py:192"),  # _dgrid_multi_kernel
    "warp_bwd_dx": ("facevae_tpu_torch/csrc/warp_bwd.cu",
                    "facevae_tpu/ops/pallas/warp_mm.py:247"),     # _drows_multi_kernel
    "grid_fwd": ("facevae_tpu_torch/csrc/warp_grid.cu",
                 "facevae_tpu/ops/pallas/warp_mm.py:358"),     # _fwd_kernel
    "grid_bwd_dgrid": ("facevae_tpu_torch/csrc/warp_grid.cu",
                       "facevae_tpu/ops/pallas/warp_mm.py:415"),  # _dgrid_kernel
    "grid_bwd_dx": ("facevae_tpu_torch/csrc/warp_grid.cu",
                    "facevae_tpu/ops/pallas/warp_mm.py:435"),     # _drows_kernel
    # the dx kernels' deterministic variants (torch.use_deterministic_algorithms)
    "warp_bwd_dx_det": ("facevae_tpu_torch/csrc/warp_bwd.cu",
                        "facevae_tpu/ops/pallas/warp_mm.py:247"),
    "grid_bwd_dx_det": ("facevae_tpu_torch/csrc/warp_grid.cu",
                        "facevae_tpu/ops/pallas/warp_mm.py:435"),
}
# the probe path's kernels (phase 9): name -> (source, the TPU kernel it replaces)
PROBE_KERNELS = {
    "probe_warp": ("facevae_tpu_torch/csrc/probe_warp.cu",
                   "tools/proto_pallas_warp.py:43"),           # warp_kernel (pallas_warp)
    "probe_banded_warp": ("facevae_tpu_torch/csrc/probe_warp.cu",
                          "tools/proto_banded_warp.py:120"),   # banded_fwd_kernel (run_banded)
    "probe_gather": ("facevae_tpu_torch/csrc/probe_gather.cu",
                     "tools/microbench_pallas_gather.py:25"),  # gather_kernel (run_case)
    "probe_lane_gather": ("facevae_tpu_torch/csrc/probe_gather.cu",
                          "tools/microbench_lane_gather.py:31"),  # main's kernel
}
PROBE_TOL = 1e-5                  # the probe warps vs plain and vs kernel 1, of max|ref|
PROBE_FIT = {3.0: "1.00", 40.0: "0.08"}   # probe 8's ZB fit rates at its thetas
N_BATCH, VOLUME = 8, (16, 64, 64)     # batch 8, D x H x W of the appearance volume
ALL, BOTH = ("fwd", "bwd_dgrid", "bwd_dx"), ("float32", "bfloat16")
# call sites: (site, kernel family, C, K1 or gps, volume, dtypes, halves, in
# the JSON line).  The "kernels" JSON line sums the fp32 rows of the main
# paths' sites: MFE and the Generator for the multi-grid kernels (the
# Generator's runs at bf16), the Generator for the single-grid ones.
SITES = (("MFE", "warp", 4, 15, VOLUME, BOTH, ALL, True),
         ("MFE sparse motion", "warp", 4, 15, VOLUME, BOTH, ALL, False),
         ("MFE sparse motion + probes", "warp", 4, 15, VOLUME, BOTH, ALL, False),
         ("Generator", "warp", 32, 1, VOLUME, BOTH, ALL, True),
         ("TPS", "warp", 3, 1, (1, 256, 256), ("bfloat16",), ("fwd",), False),
         ("Generator", "grid", 32, 1, VOLUME, BOTH, ALL, True),
         ("MFE reference form", "grid", 4, 16, VOLUME, BOTH, ALL, False))
HBM_BYTES_PER_S = 3.35e12         # H100 SXM
FP32_FLOPS = 67e12                # H100 SXM, fp32 outside the tensor cores
# kernel vs plain limits, relative to max|plain|: the forward and dgrid
# differ only in the order of their fp32 sums (dgrid reads the same bf16
# values as fp32 in both); dx sums with atomics in varying order (fp32) and
# rounds each output to bf16 once (bf16)
KERNEL_TOL = {"fwd": {"float32": 1e-5, "bfloat16": 1e-2},
              "bwd_dgrid": {"float32": 1e-5, "bfloat16": 1e-5},
              "bwd_dx": {"float32": 1e-5, "bfloat16": 1e-2}}
CROSS_TOL = 1e-5                  # single-grid vs multi-grid forward, same samples
# card vs CPU training step: fp32 as tests/test_torch_train.py, within
# SPREAD x the CPU step's own change under inputs nudged by NUDGE, plus these;
# bf16 as tests/test_torch_bf16.py, within BF16_SPREAD x the bf16 noise the
# recorded step carries (the CPU's bf16-vs-fp32 difference and its bf16
# changes under inputs nudged by half a bf16 ulp), plus these
TRAIN_TOL = {"loss": 1e-4, "grad": 1e-3, "grad_floor": 1e-2}
SPREAD, NUDGE = 10.0, 2.0 ** -20
BF16_TRAIN_TOL = {"loss": 1e-3, "grad": 1e-2, "grad_floor": 1e-2}
BF16_SPREAD, BF16_NUDGE = 3.0, 2.0 ** -9
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
        spills = [ln.strip() for ln in info["ptxas"].splitlines()
                  if "spill" in ln and not ln.strip().startswith("0 bytes stack frame, 0")]
        print(f"[build]   {len(regs)} entry points; {regs[0] if regs else ''}; "
              f"{len(spills)} with spills or a stack frame {spills}")
    print(f"[build] all libraries in {time.perf_counter() - t0:.2f} s (in parallel)")


def _bound_ms(half, N, D, H, W, C, K1, item):
    """Least time for a kernel's work on an H100: each input read once and
    each output written once over 3.35 TB/s, against its fp32 operations
    (8 corners x (C multiply-adds + weights) per sample) over 67 TFLOP/s.
    Both warp families move the same bytes for the same samples."""
    NV = D * H * W
    vol, coords, samples = N * NV * C * item, 3 * N * K1 * NV * 4, N * NV * K1 * C * item
    nbytes = {"fwd": vol + coords + samples,
              "bwd_dgrid": vol + coords + samples + 3 * N * K1 * NV * 4,
              "bwd_dx": coords + samples + N * NV * C * 4}[half]
    flops = N * K1 * NV * 8 * (2 * C + 12)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _library_calls(x, grid, gout):
    """F.grid_sample (3D, bilinear, zeros, align_corners=True) on the same
    samples, in x's dtype: x [N,D,H,W,C] repeated per grid as NCDHW, the
    normalized grid [G,D,H,W,3] (rounded to bf16 for a bf16 x, as
    F.grid_sample takes one dtype: a yardstick of time, never compared), the
    cotangent [G,D,H,W,C]; its forward, and its backward (the one aten call
    autograd makes, so a CUDA graph can hold it) for the grid alone and for
    the source alone."""
    import torch
    import torch.nn.functional as F
    N, D, H, W, C = x.shape
    G = grid.shape[0]
    src = (x.permute(0, 4, 1, 2, 3)[:, None].expand(N, G // N, C, D, H, W)
           .reshape(G, C, D, H, W).contiguous())
    grid = torch.nan_to_num(grid, posinf=1e6, neginf=-1e6).to(x.dtype)
    g = gout.to(x.dtype).permute(0, 4, 1, 2, 3).contiguous()

    def bwd(mask):
        # interpolation 0 = bilinear, padding 0 = zeros, align_corners
        return lambda: torch.ops.aten.grid_sampler_3d_backward(g, src, grid, 0, 0, True, mask)

    return {"fwd": lambda: F.grid_sample(src, grid, mode="bilinear", padding_mode="zeros",
                                         align_corners=True),
            "bwd_dgrid": bwd([False, True]), "bwd_dx": bwd([True, False])}


def _deterministic(fn):
    """fn() under torch.use_deterministic_algorithms(True), where the
    wrappers launch the dx kernels' deterministic variants; the mode off
    after."""
    import torch
    torch.use_deterministic_algorithms(True)
    try:
        return fn()
    finally:
        torch.use_deterministic_algorithms(False)


def _site_calls(family, x, coords, grid, gout, gps, spatial):
    """name -> (kernel call, plain call) of one site's kernels."""
    from facevae_tpu_torch.ops import fast_warp as fw
    if family == "warp":
        return {
            "warp_fwd": (lambda: fw.warp_multi_pixel_cuda(x, *coords, spatial),
                         lambda: fw.warp_multi_pixel_plain(x, *coords, spatial)),
            "warp_bwd_dgrid": (
                lambda: fw.warp_multi_pixel_bwd_cuda(x, *coords, gout, spatial, False)[1],
                lambda: fw.warp_multi_pixel_bwd_plain(x, *coords, gout, spatial, False)[1]),
            "warp_bwd_dx": (
                lambda: fw.warp_multi_pixel_bwd_cuda(x, *coords, gout, spatial,
                                                     need_dgrid=False)[0],
                lambda: fw.warp_multi_pixel_bwd_plain(x, *coords, gout, spatial,
                                                      need_dgrid=False)[0]),
            "warp_bwd_dx_det": (
                lambda: _deterministic(lambda: fw.warp_multi_pixel_bwd_cuda(
                    x, *coords, gout, spatial, need_dgrid=False)[0]),
                lambda: fw.warp_multi_pixel_bwd_plain(x, *coords, gout, spatial,
                                                      need_dgrid=False)[0])}
    return {
        "grid_fwd": (lambda: fw.grid_sample_3d_cuda(x, grid, gps),
                     lambda: fw.grid_sample_3d_plain(x, grid, gps)),
        "grid_bwd_dgrid": (lambda: fw.grid_sample_3d_bwd_cuda(x, grid, gout, gps, False)[1],
                           lambda: fw.grid_sample_3d_bwd_plain(x, grid, gout, gps, False)[1]),
        "grid_bwd_dx": (lambda: fw.grid_sample_3d_bwd_cuda(x, grid, gout, gps,
                                                           need_dgrid=False)[0],
                        lambda: fw.grid_sample_3d_bwd_plain(x, grid, gout, gps,
                                                            need_dgrid=False)[0]),
        "grid_bwd_dx_det": (lambda: _deterministic(lambda: fw.grid_sample_3d_bwd_cuda(
                                x, grid, gout, gps, need_dgrid=False)[0]),
                            lambda: fw.grid_sample_3d_bwd_plain(x, grid, gout, gps,
                                                                need_dgrid=False)[0])}


def _permuted_dx(x, coords, gout, spatial):
    """The deterministic multi-grid dx with the K1 grids and their gout
    columns permuted (a seeded permutation from a generator of its own, so
    phase 3's draws stay as they were)."""
    import torch
    from facevae_tpu_torch.ops import fast_warp as fw
    N, C, K1 = x.shape[0], x.shape[-1], coords[0].shape[1]
    perm = torch.randperm(K1, generator=torch.Generator().manual_seed(K1)).to(x.device)
    pgout = gout.reshape(N, -1, K1, C)[:, :, perm].reshape(gout.shape).contiguous()
    return _deterministic(lambda: fw.warp_multi_pixel_bwd_cuda(
        x, *(c[:, perm].contiguous() for c in coords), pgout, spatial, need_dgrid=False)[0])


def _cross_check(x, grid, gps):
    """The single-grid forward against the multi-grid forward on the same
    samples (the pixel coordinates unnormalized as the single-grid kernel
    does): (max|err|, max|ref|, bit-equal)."""
    import torch
    from facevae_tpu_torch.ops import fast_warp as fw
    N, D, H, W, C = x.shape
    single = fw.grid_sample_3d_cuda(x, grid, gps)
    coords = [((grid[..., a] + 1.0) * 0.5 * (s - 1)).reshape(N, gps, -1).contiguous()
              for a, s in enumerate((W, H, D))]
    multi = fw.warp_multi_pixel_cuda(x, *coords, tuple(grid.shape[1:4]))
    multi = multi.reshape(N, -1, gps, C).permute(0, 2, 1, 3).reshape(single.shape)
    torch.cuda.synchronize()
    return ((single - multi).abs().max().item(), multi.abs().max().item(),
            bool(torch.equal(single, multi)))


def phase_kernels():
    import torch
    from facevae_tpu_torch.warp_inputs import (noisy_coords, normalized, reference_form_grid,
                                               sparse_motion_coords)
    from facevae_tpu_torch.probes.common import graph_ms
    g = torch.Generator(device="cuda").manual_seed(0)
    rows, cross = [], []
    N = N_BATCH
    for site, family, C, K1, (D, H, W), dtypes, halves, in_json in SITES:
        spatial = (D, H, W)
        coords = grid = None
        if site == "MFE reference form":
            grid = reference_form_grid(N, K1 - 1, D, H, W, g)
        else:
            coords = (sparse_motion_coords(N, K1, D, H, W, g, probes=site.endswith("probes"))
                      if site.startswith("MFE sparse motion") else noisy_coords(N, K1, D, H, W, g))
            if site == "TPS":                      # a D=1 frame: z is exactly 0
                coords[2] = torch.zeros_like(coords[2])
            grid = normalized(coords, D, H, W)     # the same samples, normalized
        for dname in dtypes:
            dtype = getattr(torch, dname)
            x = torch.randn(N, D, H, W, C, generator=g, device="cuda").to(dtype)
            gout_gm = torch.randn(N * K1, D, H, W, C, generator=g, device="cuda").to(dtype)
            # the multi-grid ops take the cotangent k-major [N,D,H,W,K1*C]
            gout = (gout_gm if family == "grid" else
                    gout_gm.reshape(N, K1, -1, C).permute(0, 2, 1, 3).reshape(N, D, H, W, K1 * C))
            calls = _site_calls(family, x, coords, grid, gout, K1, spatial)
            library = _library_calls(x, grid, gout_gm)
            for name, (kernel, plain) in calls.items():
                half = name.split("_", 1)[1].removesuffix("_det")
                if half not in halves:
                    continue
                out, ref = kernel(), plain()
                torch.cuda.synchronize()
                out = out if isinstance(out, tuple) else (out,)
                ref = ref if isinstance(ref, tuple) else (ref,)
                what = f"{name} {site} {dname}"
                check(all(bool(torch.isfinite(o).all()) for o in out), f"{what}: non-finite output")
                check(all(o.shape == r.shape for o, r in zip(out, ref)),
                      f"{what}: shapes {[tuple(o.shape) for o in out]}")
                err = max((o.float() - r.float()).abs().max().item() for o, r in zip(out, ref))
                scale = max(r.float().abs().max().item() for r in ref)
                row = dict(name=name, site=site, dtype=dname, C=C, K1=K1, shape=(N, D, H, W, C),
                           err=err, scale=scale, tol=KERNEL_TOL[half][dname] * scale,
                           ms=graph_ms(kernel), event_ms=cuda_ms(kernel),
                           plain_ms=cuda_ms(plain), in_json=in_json,
                           library_ms=graph_ms(library[half]))
                row["bound_ms"], row["bound_by"] = _bound_ms(half, N, D, H, W, C, K1,
                                                             x.element_size())
                if half == "bwd_dx":
                    again = kernel()
                    row["rerun_diff"] = (again.float() - out[0].float()).abs().max().item()
                    row["rerun_equal"] = bool(torch.equal(again, out[0]))
                if name == "warp_bwd_dx_det" and K1 > 1:
                    row["permuted_equal"] = bool(torch.equal(
                        _permuted_dx(x, coords, gout, spatial), out[0]))
                rows.append(row)
                rerun = (f"; run-to-run max|diff| {row['rerun_diff']:.3e}"
                         if "rerun_diff" in row else "")
                if "permuted_equal" in row:
                    rerun += f"; K1 grids permuted: bit for bit {row['permuted_equal']}"
                k = "gps" if family == "grid" else "K1"
                print(f"[kernels] {name} {site} x[{N},{D},{H},{W},{C}] {k}={K1} {dname}: "
                      f"max|err| {err:.3e} (limit {row['tol']:.3e}, max|ref| {scale:.3f}); "
                      f"device {row['ms']:.4f} ms (event {row['event_ms']:.4f}), plain "
                      f"{row['plain_ms']:.4f}, F.grid_sample {row['library_ms']:.4f}, "
                      f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}){rerun}")
            if family == "warp":
                nbytes = N * D * H * W * K1 * C * x.element_size()
                tiled = " through its shared-memory tile" if K1 > 1 else ""
                print(f"[kernels]   kernel 1 {site} {dname}: stores {nbytes} B{tiled}"
                      + (f"; kernel 2 reads a cotangent of {nbytes} B, k-major"
                         if "bwd_dgrid" in halves else ""))
            if (family == "grid" and dname == "float32") or site == "TPS":
                err, scale, same = _cross_check(x, grid, K1)
                cross.append((site, err, scale, same))
                print(f"[kernels] single-grid vs multi-grid forward, {site} gps=K1={K1} {dname}: "
                      f"max|err| {err:.3e} (limit {CROSS_TOL * scale:.3e}); "
                      f"bit for bit: {'yes' if same else 'no'}")
    for r in rows:
        check(r["err"] <= r["tol"], f"{r['name']} {r['site']} {r['dtype']}: "
                                    f"{r['err']:.3e} > {r['tol']:.3e}")
        if r["name"].endswith("_det"):
            check(r["rerun_equal"] and r.get("permuted_equal", True),
                  f"{r['name']} {r['site']} {r['dtype']}: not deterministic (run-to-run "
                  f"{r['rerun_diff']:.3e}, K1 permuted equal {r.get('permuted_equal')})")
    for r in rows:
        if r["name"].endswith("_det"):
            base = next(b for b in rows if b["name"] == r["name"][:-4]
                        and (b["site"], b["dtype"]) == (r["site"], r["dtype"]))
            print(f"[kernels] {r['name']} {r['site']} {r['dtype']}: {r['ms']:.4f} ms, "
                  f"{r['ms'] / base['ms']:.2f}x the default dx kernel's {base['ms']:.4f} ms")
    for site, err, scale, _ in cross:
        check(err <= CROSS_TOL * scale, f"single-grid vs multi-grid forward at {site}: "
                                        f"{err:.3e} > {CROSS_TOL * scale:.3e}")
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
        want = {**dict.fromkeys(counts, 0), "warp_fwd": batches, "grid_fwd": batches}
        check(counts == want, f"warp launches {counts} for {batches} batches: expected "
                              f"{want} (MFE's multi-grid and the Generator's single-grid "
                              "forward once per batch, no plain version)")
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


# per training step: fp32 runs MFE through the multi-grid kernels and the
# Generator through the single-grid ones; bf16 runs MFE, the Generator and
# the TPS warp (forward only) through the multi-grid kernels
STEP_LAUNCHES = {"float32": {"warp_fwd": 1, "warp_bwd_dgrid": 1, "warp_bwd_dx": 1,
                             "grid_fwd": 1, "grid_bwd_dgrid": 1, "grid_bwd_dx": 1},
                 "bfloat16": {"warp_fwd": 3, "warp_bwd_dgrid": 2, "warp_bwd_dx": 2}}


def _want(counts, dtype, steps, deterministic=False):
    """The launch counts of ``steps`` steps: STEP_LAUNCHES, the dx kernels'
    deterministic variants in their place under deterministic algorithms,
    every other count (the plain versions) 0."""
    per_step = {(k + "_det" if deterministic and k.endswith("_dx") else k): v
                for k, v in STEP_LAUNCHES[dtype].items()}
    return {**dict.fromkeys(counts, 0), **{k: steps * v for k, v in per_step.items()}}


def numpy_weights(nets, seed):
    """Fill every parameter and buffer of ``nets`` (dict order, then
    state_dict order) from numpy's RandomState(seed), which draws the same
    numbers on every machine and torch version: kernels and biases
    U(-1/sqrt(fan_in), +), norm scales U(0.8, 1.2), norm biases and running
    means U(-0.1, 0.1), running variances U(0.5, 1.5), spectral u, v by 20
    power iterations on the filled kernel."""
    import numpy as np
    import torch
    rs = np.random.RandomState(seed)
    for net in nets.values():
        sd = net.state_dict()
        vals = {}
        for key, t in sd.items():
            stem, leaf = key.rpartition(".")[::2]
            kernel = sd.get(f"{stem}.weight" if stem else "weight")
            if leaf in ("weight_u", "weight_v"):
                continue
            if t.dim() >= 2 or (leaf == "bias" and kernel is not None and kernel.dim() >= 2):
                fan_in = kernel[0].numel()
                vals[key] = rs.uniform(-1, 1, tuple(t.shape)) / np.sqrt(fan_in)
            elif leaf == "weight":
                vals[key] = rs.uniform(0.8, 1.2, tuple(t.shape))
            elif leaf in ("bias", "running_mean"):
                vals[key] = rs.uniform(-0.1, 0.1, tuple(t.shape))
            elif leaf == "running_var":
                vals[key] = rs.uniform(0.5, 1.5, tuple(t.shape))
            else:
                raise ValueError(f"numpy_weights: no rule for {key}")
        for key in sd:
            stem, leaf = key.rpartition(".")[::2]
            if leaf == "weight_u":
                w = vals[f"{stem}.weight"].reshape(sd[key].shape[0], -1)
                u = rs.randn(w.shape[0])
                for _ in range(20):
                    v = w.T @ u
                    v /= np.linalg.norm(v)
                    u = w @ v
                    u /= np.linalg.norm(u)
                vals[key], vals[f"{stem}.weight_v"] = u, v
        with torch.no_grad():
            for key, t in sd.items():
                t.copy_(torch.from_numpy(np.asarray(vals[key], np.float32)))
    return nets


def tiny_step_inputs(seed=0):
    """The images [4][2,64,64,3] and TPS parameters of the tiny step, from
    numpy: (RandomState after the draws, images, (theta, control points,
    control params))."""
    import numpy as np
    rs = np.random.RandomState(seed)
    batch = [rs.rand(2, 64, 64, 3).astype(np.float32) for _ in range(4)]
    y, x = np.meshgrid(np.linspace(-1, 1, 5), np.linspace(-1, 1, 5), indexing="ij")
    tp = ((np.eye(2, 3)[None] + 0.05 * rs.randn(2, 2, 3)).astype(np.float32),
          np.stack([x, y], -1).reshape(1, 25, 2).astype(np.float32),
          (0.005 * rs.randn(2, 1, 25)).astype(np.float32))
    return rs, batch, tp


def tiny_step(device, images, dtype, tp, seed=0):
    """One tiny_config(compute_dtype=dtype) training step of the port on
    ``device`` from numpy_weights(seed): ({loss: value}, {net: {param:
    gradient}}), numpy."""
    import torch
    from facevae_tpu_torch.config import tiny_config
    from facevae_tpu_torch.models import D_MODEL_NAMES, G_MODEL_NAMES
    from facevae_tpu_torch.ops.tps import TransformParams
    from facevae_tpu_torch.train import build_all_modules, create_train_state, train_step
    cfg = tiny_config(compute_dtype=dtype)
    nets = numpy_weights(build_all_modules(cfg, device), seed)
    state = create_train_state(cfg, device, nets)
    out = train_step(state, [torch.from_numpy(b).to(device) for b in images],
                     transform_params=TransformParams(*(torch.from_numpy(a).to(device)
                                                        for a in tp)))
    losses = {k: float(v) for k, v in {**out["losses_g"], **out["losses_d"]}.items()}
    grads = {n: {k: p.grad.detach().cpu().numpy() for k, p in state.nets[n].named_parameters()}
             for n in G_MODEL_NAMES + D_MODEL_NAMES}
    return losses, grads


def held_step(losses, grads, ref_losses, ref_grads, noise, factor, tol):
    """Hold a step's losses and gradients to a reference step's: each within
    factor x its rounding noise (noise(kind, name, key) -> a max distance)
    + tol's floor.  Returns (failures, worst err/limit)."""
    import numpy as np
    bad, worst = [], 0.0

    def hold(what, a, r, n, rel, scale):
        nonlocal worst
        err = _distance(a, r)
        lim = factor * n + rel * scale
        worst = max(worst, err / lim if lim > 0 else (0.0 if err == 0 else float("inf")))
        if not err <= lim:
            bad.append(f"{what}: {err:.3e} > {lim:.3e}")

    for k, v in losses.items():
        hold(f"loss {k}", v, ref_losses[k], noise("loss", k, None), tol["loss"],
             abs(ref_losses[k]))
    for n, gs in grads.items():
        top = max(float(np.abs(g).max()) for g in ref_grads[n].values())
        for k, g in gs.items():
            r = ref_grads[n][k]
            hold(f"{n}.{k} grad", g, r, noise("grad", n, k), tol["grad"],
                 max(float(np.abs(r).max()), tol["grad_floor"] * top))
    return bad, worst


def _distance(a, b):
    import numpy as np
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def phase_train_tiny():
    """One tiny_config() step on the card against the port's step on the
    CPU, from the same numpy weights, images and TPS parameters: fp32
    against a CPU step here; bf16 against the CPU bf16 step recorded in
    tests/data/torch_bf16_step_tiny.npz (tools/make_torch_step_golden.py:
    run on the card's machine, two CPU bf16 steps did not finish in 20
    minutes)."""
    import numpy as np
    import torch
    from facevae_tpu_torch.ops import fast_warp
    rs, batch, tp = tiny_step_inputs()
    nudged = [(b * (1 + NUDGE * rs.randn(*b.shape))).astype(np.float32) for b in batch]
    cpu, cpu_nudged = tiny_step("cpu", batch, "float32", tp), tiny_step("cpu", nudged, "float32", tp)
    z = np.load(BF16_STEP_GOLDEN)
    gold = ({k[len("loss/"):]: float(z[k]) for k in z.files if k.startswith("loss/")},
            {})
    for k in z.files:
        if k.startswith("grad/"):
            _, n, key = k.split("/", 2)
            gold[1].setdefault(n, {})[key] = z[k]
    refs = {
        "float32": (cpu, lambda kind, n, k: (_distance(cpu_nudged[0][n], cpu[0][n]) if kind == "loss"
                                              else _distance(cpu_nudged[1][n][k], cpu[1][n][k])),
                    SPREAD, TRAIN_TOL),
        "bfloat16": (gold, lambda kind, n, k: float(z[f"noise/loss/{n}" if kind == "loss"
                                                       else f"noise/grad/{n}/{k}"]),
                     BF16_SPREAD, BF16_TRAIN_TOL)}
    det_paths = {}
    for dtype, ((ref_losses, ref_grads), noise, factor, tol) in refs.items():
        for det in (False, True):
            tag = f"{dtype}{' deterministic' if det else ''}"
            fast_warp.reset_launch_counts()
            # strict: an op of the step without a deterministic implementation raises
            torch.use_deterministic_algorithms(det)
            try:
                losses, grads = tiny_step("cuda", batch, dtype, tp)
                torch.cuda.synchronize()
            except RuntimeError as e:
                raise PhaseError(f"tiny {tag} step raised: {e}") from e
            finally:
                torch.use_deterministic_algorithms(False)
            launches = dict(fast_warp.launches)
            bad, worst = held_step(losses, grads, ref_losses, ref_grads, noise, factor, tol)
            print(f"[train_tiny] {tag}: card vs CPU step, tiny_config batch 2: losses "
                  + ", ".join(f"{k} {v:.5f}/{ref_losses[k]:.5f}" for k, v in losses.items()))
            print(f"[train_tiny] {tag}: {sum(len(g) for g in grads.values())} gradient leaves "
                  f"and {len(losses)} losses held; worst err/limit {worst:.3f}; "
                  f"card launches {launches}")
            if det:
                det_paths[f"train_tiny_det_{dtype}"] = launches
            check(not bad, f"{tag} card step differs from the CPU step: {bad[:8]}")
            check(launches == _want(launches, dtype, 1, det), f"tiny {tag} step launches {launches}")
    return det_paths


def _train(card, dtype):
    """The full-width training step through the bench's function."""
    from facevae_tpu_torch import bench
    tag = "train" if dtype == "float32" else "train_bf16"
    r = bench.run(batch_size=N_BATCH, steps=TRAIN_STEPS, warmup=TRAIN_WARMUP, dtype=dtype)
    bad = [k for k, v in r["losses"].items() if not abs(v) < float("inf")]
    check(not bad, f"non-finite losses {bad}: {r['losses']}")
    check(r["param_dtypes"] == r["adam_dtypes"] == ["torch.float32"],
          f"parameters {r['param_dtypes']}, Adam state {r['adam_dtypes']}: want fp32")
    want = _want(r["launches"], dtype, TRAIN_STEPS)
    check(r["launches"] == want,
          f"{TRAIN_STEPS} {dtype} training steps launched {r['launches']}, want {want}")
    print(f"[{tag}] {card}: {r['config']}: step {r['step_ms_median']:.1f} ms median "
          f"({', '.join(f'{t:.1f}' for t in r['step_ms'])}), {r['frames_per_s']:.3f} frames/s, "
          f"peak memory {r['peak_memory_bytes'] / 2 ** 30:.2f} GiB, "
          f"build + state {r['build_s']:.1f} s; parameters and Adam state fp32")
    print(f"[{tag}] losses {json.dumps({k: round(v, 5) for k, v in r['losses'].items()})}; "
          f"warp launches over {TRAIN_STEPS} steps {r['launches']}")
    return r["launches"]


def _probe_row(name, out, ref, r, plain_ms, site):
    """One kernel-vs-plain comparison of phase 9 (out, ref: the two results
    on the same inputs; r: the probe's run() figures)."""
    import torch
    torch.cuda.synchronize()
    check(out.shape == ref.shape and out.dtype == ref.dtype,
          f"{name} {site}: {tuple(out.shape)} {out.dtype} vs plain {tuple(ref.shape)} {ref.dtype}")
    err = (out.float() - ref.float()).abs().max().item() if out.numel() else 0.0
    scale = ref.float().abs().max().item() if ref.numel() else 0.0
    return dict(name=name, site=site, err=err, scale=scale, equal=bool(torch.equal(out, ref)),
                ms=r["ms"], plain_ms=plain_ms, library_ms=r["library_ms"],
                bound_ms=r["bound_ms"], bound_by=r["bound_by"])


def phase_probes():
    """The probe path (each probe's run(), as its entry point calls it),
    then each probe kernel against its plain version."""
    import torch
    from facevae_tpu_torch.probes import common as pc
    from facevae_tpu_torch.probes import microbench_gather as p9
    from facevae_tpu_torch.probes import microbench_lane_gather as p10
    from facevae_tpu_torch.probes import proto_banded_warp as p8
    from facevae_tpu_torch.probes import proto_warp as p7
    mods = {"probe_warp": p7, "probe_banded_warp": p8, "probe_gather": p9,
            "probe_lane_gather": p10}
    dev = torch.device("cuda")
    for m in mods.values():
        m.reset_launch_counts()
    r7, r8, r9, r10 = p7.run(dev), p8.run(dev), p9.run(dev), p10.run(dev)
    torch.cuda.synchronize()
    counts = {k: v for m in mods.values() for k, v in m.launches.items()}
    print(f"[probes] launches on the probe path {counts}")
    check(all(counts[k] > 0 for k in mods) and not any(counts[k + "_plain"] for k in mods),
          f"probe path launches {counts}: want every probe kernel, no plain version")

    volT, gx, gy, gz, shape = r7["args"]
    row = _probe_row("probe_warp", p7.proto_warp_cuda(volT, gx, gy, gz, shape),
                     p7.proto_warp_plain(volT, gx, gy, gz, shape), r7,
                     pc.graph_ms(lambda: p7.proto_warp_plain(volT, gx, gy, gz, shape)),
                     f"P={gx.shape[1]}")
    rows = [row]
    print(f"[probes] probe_warp: {r7['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
          f"F.grid_sample {r7['library_ms']:.4f} ms, one-hot partner {r7['onehot_ms']:.4f} ms, "
          f"bound {r7['bound_ms'] * 1e3:.3f} us; vs plain max|err| {row['err']:.3e} (max|ref| "
          f"{row['scale']:.3f}); vs the probe's oracle {r7['err']:.4f} on the fp32 volume "
          f"(bf16 table), {r7['err_exact']:.3e} on the bf16 volume")
    check(row["err"] <= PROBE_TOL * row["scale"], f"probe_warp: {row['err']:.3e}")
    check(r7["err_exact"] <= PROBE_TOL * r7["scale"],
          f"probe_warp vs the oracle on the bf16 volume: {r7['err_exact']:.3e}")
    for mode, num in r8["numerics"].items():
        print(f"[probes] probe_banded_warp {mode} vs the probe's host oracle (n=0..1, theta=3): "
              + ("not checked (a box exceeds the budget)" if num is None else
                 f"max abs {num[0]:.3e}, rel {num[1]:.3e}"))
        check(num is None or num[1] <= PROBE_TOL, f"probe_banded_warp {mode} vs host: {num}")
    for t in r8["thetas"]:
        args = t["args"]
        plain = p8.banded_warp_plain(*args)
        plain_ms = pc.graph_ms(lambda: p8.banded_warp_plain(*args))
        fit = f"{t['probe_fit']:.2f}"
        print(f"[probes] probe_banded_warp theta={t['theta']}: probe fit rate {fit} "
              f"(ZB={p8.ZB}); kernel 1 {t['kernel1_ms']:.4f} ms on bf16 x, "
              f"{t['kernel1_fp32_ms']:.4f} ms on fp32 x; nothing staged (blockwhen, budget "
              f"1 row) {t['unstaged_ms']:.4f} ms; F.grid_sample "
              f"{t['library_ms']:.4f} ms; bound {t['bound_ms']:.4f} ms ({t['bound_by']}); "
              f"plain {plain_ms:.4f} ms")
        check(fit == PROBE_FIT[t["theta"]], f"probe fit rate at theta={t['theta']}: {fit}")
        for mode, m in t["modes"].items():
            out = p8.banded_warp_cuda(*args, mode=mode)
            exact = m["vs_kernel1"] is not None
            row = _probe_row("probe_banded_warp", out, plain, dict(t, ms=m["ms"]), plain_ms,
                             f"theta={t['theta']} {mode}")
            row.update(mode=mode, exact=exact, staged=m["staged"])
            rows.append(row)
            k1 = m["vs_kernel1"]
            print(f"[probes]   {mode}: {m['ms']:.4f} ms ({t['kernel1_ms'] / m['ms']:.2f}x kernel "
                  f"1); boxes staged {m['staged']:.4f} (budget {p8.BUDGET} rows; as the "
                  f"host reckons: {m['flags_match']}); vs plain "
                  + (f"max|err| {row['err']:.3e} (max|ref| {row['scale']:.3f})" if exact else
                     "not checked (bandonly, a box exceeds the budget)")
                  + ("" if k1 is None else f"; vs kernel 1 fp32 max|err| {k1[0]:.3e}, bit for "
                     f"bit {'yes' if k1[2] else 'no'}"))
            check(m["flags_match"], f"{mode} theta={t['theta']} staged other boxes than "
                                    "staged_flags reckons")
            check(not exact or row["err"] <= PROBE_TOL * row["scale"],
                  f"probe_banded_warp {mode} theta={t['theta']}: {row['err']:.3e}")
            check(k1 is None or k1[0] <= PROBE_TOL * k1[1],
                  f"probe_banded_warp {mode} vs kernel 1 theta={t['theta']}: {k1}")
    for r in r9:
        table, idx = r["args"]
        row = _probe_row("probe_gather", p9.gather_cuda(table, idx), p9.gather_plain(table, idx),
                         r, pc.graph_ms(lambda: p9.gather_plain(table, idx)), f"SxTxP={r['case']}")
        rows.append(row)
        print(f"[probes] probe_gather S,T,P={r['case']}: bit for bit vs plain {row['equal']}, "
              f"vs numpy {r['equal']}; {r['ms'] * 1e3:.2f} us ({r['gbps']:.1f} GB/s), plain "
              f"{row['plain_ms'] * 1e3:.2f} us, torch.gather {r['library_ms'] * 1e3:.2f} us, "
              f"bound {r['bound_ms'] * 1e3:.3f} us")
        check(row["equal"] and r["equal"], f"probe_gather {r['case']} differs")
    data, idx = r10["args"]
    row = _probe_row("probe_lane_gather", p10.lane_gather_cuda(data, idx),
                     p10.lane_gather_plain(data, idx), r10,
                     pc.graph_ms(lambda: p10.lane_gather_plain(data, idx)), f"NB={idx.shape[0]}")
    rows.append(row)
    print(f"[probes] probe_lane_gather: bit for bit vs plain {row['equal']}, vs numpy "
          f"{r10['equal']}; {r10['ms']:.4f} ms ({r10['gbps']:.1f} GB/s), plain "
          f"{row['plain_ms']:.4f} ms, torch.gather {r10['library_ms']:.4f} ms, bound "
          f"{r10['bound_ms']:.4f} ms")
    check(row["equal"] and r10["equal"], "probe_lane_gather differs")
    return rows, counts


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
    phase_s, paths = {}, {}
    try:
        card = phase_device()
        for name, fn in (("build", phase_build), ("kernels", phase_kernels),
                         ("golden", phase_golden), ("serve", lambda: phase_serve(card)),
                         ("train_tiny", phase_train_tiny),
                         ("train", lambda: _train(card, "float32")),
                         ("train_bf16", lambda: _train(card, "bfloat16")),
                         ("probes", phase_probes)):
            t0 = time.perf_counter()
            out = fn()
            phase_s[name] = round(time.perf_counter() - t0, 1)
            if name == "kernels":
                rows = out
            elif name in ("serve", "train", "train_bf16"):
                paths[name] = out                  # each main path's launch counts
            elif name == "train_tiny":
                det_paths = out                    # the deterministic mode's steps
            elif name == "probes":
                probe_rows, probe_counts = out
    except PhaseError as e:
        print(f"FAIL: {e}", flush=True)
        return 1
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        # the kernel's fp32 calls at the main paths' sites (SITES); the
        # deterministic variants launch on the deterministic steps of phase 6
        fp32 = [r for r in rows if r["name"] == name and r["dtype"] == "float32" and r["in_json"]]
        counted = det_paths if name.endswith("_det") else paths
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(p[name] for p in counted.values()),
            "launches_by_path": {k: p[name] for k, p in counted.items()},
            "max_abs_err": max(r["err"] for r in fp32),
            "ms": sum(r["ms"] for r in fp32), "event_ms": sum(r["event_ms"] for r in fp32),
            "plain_ms": sum(r["plain_ms"] for r in fp32),
            "bound_ms": sum(r["bound_ms"] for r in fp32), "bound_by": fp32[0]["bound_by"],
            "library_ms": sum(r["library_ms"] for r in fp32),
            "sites": [r["site"] for r in fp32]})
    for name, (source, replaces) in PROBE_KERNELS.items():
        # probe 8: its default mode (banded) at both thetas; probe 9: its seven cases
        mine = [r for r in probe_rows if r["name"] == name and r.get("mode", "banded") == "banded"]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": probe_counts[name], "launches_by_path": {"probes": probe_counts[name]},
            "max_abs_err": max(r["err"] for r in mine),
            "ms": sum(r["ms"] for r in mine), "plain_ms": sum(r["plain_ms"] for r in mine),
            "bound_ms": sum(r["bound_ms"] for r in mine), "bound_by": mine[0]["bound_by"],
            "library_ms": sum(r["library_ms"] for r in mine),
            "sites": [r["site"] for r in mine]})
    print(json.dumps({"kernels": kernels}))
    print(f"[done] {time.perf_counter() - t_all:.1f} s; phases {json.dumps(phase_s)}")
    print(smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
