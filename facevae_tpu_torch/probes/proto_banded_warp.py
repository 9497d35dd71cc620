"""Probe 8: the z-coherent block warp, staged against gathered (port of
tools/proto_banded_warp.py).

    python -m facevae_tpu_torch.probes.proto_banded_warp [--mode banded|blockwhen|bandonly]
        [--device cpu]

Kernel 1's MFE call: x [N=8, D=16, H=64, W=64, C=4] bf16 sampled at K1=15
pixel-coordinate grids of an affine motion with yaw theta -> [N, NV, K1*C]
fp32, k-major, from the probe's row layout rows3 [N, D*H, C*W].  A block of
VB=512 consecutive output voxels samples a narrow (z, y) range of the
source; the TPU probe asked whether it could contract a z-band of ZB=8
slices instead of the whole volume.  On the card, csrc/probe_warp.cu
(probe_banded_warp_kernel) stages the (z, y) bounding box of a block's
samples in shared memory when it fits BUDGET rows, and gathers from global
memory (L2) otherwise; the three modes are the probe's MODE variants
(banded: per (block, k); blockwhen: one box for all K1 grids of a block;
bandonly: always staged, cut to the budget, wrong where it does not fit).

It prints, as the TPU probe does, the error against the probe's exact host
oracle (n = 0..1 at theta = 3 degrees), then per theta in (3, 40): the
probe's fit rate (its ZB criterion), the share of boxes staged on the card
(the budget criterion), kernel 1's time on the same samples (bf16, the
probe's comparison partner) and this kernel's, their agreement in fp32, the
bound and F.grid_sample's time.  The coordinates are the probe's, drawn from
RandomState(0) in its order (the volume, theta=3 for the numerics, then 3
and 40 for the timings).
"""
from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch
import torch.nn.functional as F

from facevae_tpu_torch.ops import fast_warp
from facevae_tpu_torch.ops.fast_warp import _sample
from facevae_tpu_torch import kernels
from facevae_tpu_torch.probes import common

N, D, H, W, C = 8, 16, 64, 64, 4
K1, VB, ZB = 15, 512, 8
BUDGET = 160            # staged rows of C*W bf16 a block may hold: 80 KB at C*W = 256
MODES = ("banded", "blockwhen", "bandonly")
THETAS = (3.0, 40.0)
MAX_SHARED = 232448     # the dynamic shared memory a block may ask for on an H100
WARPS = 16              # the kernel's 512 threads
SPAN_BYTES = 24         # the kernel's struct Span
launches = {"probe_banded_warp": 0, "probe_banded_warp_plain": 0}


def reset_launch_counts():
    for k in launches:
        launches[k] = 0


def inputs(seed=0):
    """The probe's draws from RandomState(seed), in its order: x
    [N,D,H,W,C] (bf16 values, numpy fp32), rows3 [N, D*H, C*W] (column
    c*W + x, the same values), and coords(theta), which draws the next
    grids' offsets and returns (cgx, cgy, cgz), each [N, K1, NV] fp32."""
    rng = np.random.RandomState(seed)
    nv = D * H * W
    x = torch.from_numpy(rng.randn(N, D, H, W, C).astype(np.float32)).bfloat16().float().numpy()
    rows3 = np.ascontiguousarray(x.transpose(0, 1, 2, 4, 3)).reshape(N, D * H, C * W)

    def coords(theta_deg):
        th = np.deg2rad(theta_deg)
        jac = np.array([[np.cos(th), 0, np.sin(th)],
                        [0, 1, 0],
                        [-np.sin(th), 0, np.cos(th)]], np.float32)
        zz, yy, xx = np.meshgrid(np.arange(D), np.arange(H), np.arange(W), indexing="ij")
        gn = np.stack([xx / (W - 1) * 2 - 1, yy / (H - 1) * 2 - 1,
                       zz / (D - 1) * 2 - 1], -1).reshape(nv, 3)
        q = gn @ jac.T
        b = rng.randn(N, K1, 3).astype(np.float32) * 0.1
        cg = q[None, None] + b[:, :, None]
        return tuple(((cg[..., a] + 1) * (s - 1) / 2).astype(np.float32)
                     for a, s in enumerate((W, H, D)))

    return x, rows3, coords


def host_reference(x, cgx, cgy, cgz):
    """The probe's oracle: the exact trilinear sample (zeros padding) on the
    host, numpy: x [N,D,H,W,C], coordinates [N,K1,NV] -> [N, NV, K1*C]."""
    n_, d, h, w, c = x.shape
    k1, nv = cgx.shape[1], cgx.shape[2]
    out = np.zeros((n_, nv, k1 * c), np.float32)
    xf = np.asarray(x, np.float32)
    for n in range(n_):
        for k in range(k1):
            gx, gy, gz = (np.asarray(a[n, k], np.float32) for a in (cgx, cgy, cgz))
            x0, y0, z0 = (np.floor(g).astype(int) for g in (gx, gy, gz))
            acc = np.zeros((nv, c), np.float32)
            for dz in (0, 1):
                for dy in (0, 1):
                    for dx in (0, 1):
                        xi, yi, zi = x0 + dx, y0 + dy, z0 + dz
                        ok = ((xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
                              & (zi >= 0) & (zi < d))
                        wgt = (np.maximum(0, 1 - np.abs(xi - gx))
                               * np.maximum(0, 1 - np.abs(yi - gy))
                               * np.maximum(0, 1 - np.abs(zi - gz)))
                        v = xf[n, np.clip(zi, 0, d - 1), np.clip(yi, 0, h - 1),
                               np.clip(xi, 0, w - 1)]
                        acc += np.where(ok, wgt, 0.0)[:, None] * v
            out[n, :, k * c:(k + 1) * c] = acc
    return out


def probe_fit_rate(cgz, d, vb, zb):
    """The probe's fit rate (tools/proto_banded_warp.py:284-287): the share
    of (n, k, block of vb voxels) whose clipped z range spans at most zb - 2
    slices, i.e. whose band of zb slices holds every z corner."""
    cgz = np.asarray(cgz)
    zc = np.clip(cgz, 0, d - 1).reshape(*cgz.shape[:2], cgz.shape[2] // vb, vb)
    return float(((np.floor(zc.max(-1)) - np.floor(zc.min(-1))) <= zb - 2).mean())


def staged_flags(cgy, cgz, d, h, vb, budget, mode):
    """Where csrc/probe_warp.cu stages (its ``staged`` output), on the host:
    bool [N, NV/vb, K1], true where the (z, y) box of the block's samples
    (per k, or the union over k for blockwhen) fits ``budget`` rows."""
    return box_rows(cgy, cgz, d, h, vb, mode) <= budget


def box_rows(cgy, cgz, d, h, vb, mode):
    """The rows of each box the kernel finds, int [N, NV/vb, K1]: the (z, y)
    bounding box of a block's samples (per k, or the union over k for
    blockwhen).  A sample adds its corner rows clipped to the volume, none
    if it has no z or no y corner inside; a box with none has 0 rows."""
    fz, fy = np.floor(np.asarray(cgz)), np.floor(np.asarray(cgy))
    n, k1, nv = fz.shape
    ok = (fz >= -1) & (fz <= d - 1) & (fy >= -1) & (fy <= h - 1)
    fz, fy = np.where(ok, fz, 0).astype(np.int64), np.where(ok, fy, 0).astype(np.int64)
    per = (n, k1, nv // vb, vb)
    axes = (1, 3) if mode == "blockwhen" else (3,)

    def reduce(v, fill, fn):      # fill: where no sample adds a row (an empty box)
        return fn(np.where(ok, v, fill).reshape(per), axis=axes, keepdims=True)

    nz = reduce(np.minimum(fz + 1, d - 1), -1, np.max) - reduce(np.maximum(fz, 0), d, np.min)
    ny = reduce(np.minimum(fy + 1, h - 1), -1, np.max) - reduce(np.maximum(fy, 0), h, np.min)
    rows = np.maximum(nz + 1, 0) * np.maximum(ny + 1, 0)
    rows = np.broadcast_to(rows, (n, k1, nv // vb, 1))[..., 0]
    return np.ascontiguousarray(rows.transpose(0, 2, 1))


def rows3_to_x(rows3, shape):
    """rows3 [N, D*H, C*W] (column c*W + x) -> x [N,D,H,W,C], contiguous."""
    d, h, w, c = shape
    return rows3.reshape(rows3.shape[0], d, h, c, w).permute(0, 1, 2, 4, 3).contiguous()


def tile_stride(rowbytes, vec):
    """csrc/warp_common.cuh:tile_stride: the output tile's row stride in
    bytes, an odd count of store vectors."""
    units = -(-rowbytes // vec)
    return (units + (units % 2 == 0)) * vec


def launch_plan(shape, k1, vb, budget, mode):
    """What probe_banded_warp_kernel asks of a block (csrc/probe_warp.cu
    band_smem, ring_rows and launch_banded): the output tile's row
    ``stride``, the ring's staged rows (``ring_rows``: as many as MAX_SHARED
    holds beside the rest, at least the budget) and the dynamic shared
    memory in bytes (``smem``: 16 for the mbarrier; ``tile``, the [vb][k1*C]
    fp32 output; ``ring``, ring_rows rows of C*W bf16; ``boxes``, each box's
    warp partials and span; the tile and the ring each rounded up to 16
    bytes).  Raises ValueError where the budget's rows do not fit beside
    the rest."""
    d, h, w, c = shape
    stride = tile_stride(k1 * c * 4, c * 4)
    tile = -(-vb * stride // 16) * 16
    row = c * w * 2
    boxes = (1 if mode == "blockwhen" else k1) * (WARPS * 16 + SPAN_BYTES)
    rows = max(budget, (MAX_SHARED - 16 - tile - boxes - 15) // row)
    ring = -(-rows * row // 16) * 16
    plan = dict(stride=stride, ring_rows=rows, tile=tile, ring=ring, boxes=boxes,
                smem=16 + tile + ring + boxes)
    if plan["smem"] > MAX_SHARED:
        raise ValueError(f"VB={vb}, K1={k1}, budget {budget} rows of {c * w} bf16: a block's "
                         f"shared memory would be {plan['smem']} bytes (output tile {tile}, "
                         f"ring {ring}, boxes {boxes}), over the {MAX_SHARED} an H100 allows")
    return plan


def _check(rows3, cgx, cgy, cgz, shape, mode, vb, budget):
    d, h, w, c = shape
    if rows3.dim() != 3 or tuple(rows3.shape[1:]) != (d * h, c * w):
        raise ValueError(f"rows3 must be [N, D*H, C*W] = [N, {d * h}, {c * w}], "
                         f"got {tuple(rows3.shape)}")
    if cgx.dim() != 3 or cgx.shape[0] != rows3.shape[0] or cgy.shape != cgx.shape \
            or cgz.shape != cgx.shape:
        raise ValueError(f"coordinates must be [N, K1, NV], got {tuple(cgx.shape)} "
                         f"{tuple(cgy.shape)} {tuple(cgz.shape)}")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if vb < 1 or cgx.shape[2] % vb:
        raise ValueError(f"NV={cgx.shape[2]} must be a multiple of the block VB={vb}")
    if budget < 1:
        raise ValueError(f"budget must be at least one row, got {budget}")


def banded_warp_plain(rows3, cgx, cgy, cgz, shape, mode="banded", vb=VB, budget=BUDGET):
    """The kernel's plain version: the exact trilinear sample in fp32 (the
    port's 8-corner gather, ops/fast_warp.py), [N, NV, K1*C].  Where it
    stages makes no difference to the result, except in bandonly mode where
    a box does not fit; the plain version gives the exact answer there."""
    _check(rows3, cgx, cgy, cgz, shape, mode, vb, budget)
    launches["probe_banded_warp_plain"] += 1
    n, k1, nv = cgx.shape
    c = shape[3]
    out = _sample(rows3_to_x(rows3, shape), cgx, cgy, cgz)          # [N, K1*NV, C]
    return out.reshape(n, k1, nv, c).permute(0, 2, 1, 3).reshape(n, nv, k1 * c).float()


def banded_warp_cuda(rows3, cgx, cgy, cgz, shape, mode="banded", vb=VB, budget=BUDGET,
                     staged=None):
    """Launch probe_banded_warp_kernel on CUDA tensors: rows3 bf16 [N, D*H,
    C*W], coordinates fp32 [N, K1, NV] with NV % vb == 0, C in {1, 2, 4},
    all contiguous; ``staged`` None or uint8 [N, NV/vb, K1], which receives
    1 where a box fits the budget; the block's shared memory within
    MAX_SHARED (launch_plan).  Raises on anything else."""
    _check(rows3, cgx, cgy, cgz, shape, mode, vb, budget)
    if not rows3.is_cuda:
        raise ValueError(f"probe_banded_warp kernel needs CUDA tensors, got {rows3.device}")
    dev = rows3.device
    common.check_tensor("probe_banded_warp", "rows3", rows3, torch.bfloat16, dev)
    for name, g in (("cgx", cgx), ("cgy", cgy), ("cgz", cgz)):
        common.check_tensor("probe_banded_warp", name, g, torch.float32, dev)
    d, h, w, c = shape
    n, k1, nv = cgx.shape
    if staged is not None:
        common.check_tensor("probe_banded_warp", "staged", staged, torch.uint8, dev,
                            (n, nv // vb, k1))
    if c not in (1, 2, 4):
        raise ValueError(f"probe_banded_warp kernel takes C in (1, 2, 4), got {c}")
    launch_plan(shape, k1, vb, budget, mode)
    if n > 65535 or max(rows3.numel(), n * k1 * nv, n * nv * k1 * c) >= 2 ** 62 \
            or max(d * h * c * w, nv) >= 2 ** 31:
        raise ValueError(f"N={n}, NV={nv} exceed the kernel's launch grid or indices")
    out = torch.empty((n, nv, k1 * c), dtype=torch.float32, device=dev)
    if out.numel():
        vec = int((c * w) % 8 == 0 and rows3.data_ptr() % 16 == 0)
        fn = kernels.function("probe_warp", "facevae_probe_banded_warp",
                              [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + [ctypes.c_void_p])
        with torch.cuda.device(dev):
            kernels.launch(launches, "probe_banded_warp", fn, rows3.data_ptr(), cgx.data_ptr(),
                           cgy.data_ptr(), cgz.data_ptr(), out.data_ptr(),
                           None if staged is None else staged.data_ptr(), n, d, h, w, c, k1,
                           nv, vb, budget, MODES.index(mode), vec, common.stream(rows3))
    return out


def banded_warp(rows3, cgx, cgy, cgz, shape, mode="banded", vb=VB, budget=BUDGET):
    """The probe's warp [N, NV, K1*C] fp32: the kernel for CUDA tensors, the
    plain version for CPU ones."""
    if common.on_cuda("banded_warp", rows3):
        return banded_warp_cuda(rows3, cgx, cgy, cgz, shape, mode, vb, budget)
    return banded_warp_plain(rows3, cgx, cgy, cgz, shape, mode, vb, budget)


def _agreement(out, ref):
    """(max|out - ref|, max|ref|, bit for bit) of two tensors."""
    return ((out - ref).abs().max().item(), ref.abs().max().item(), bool(torch.equal(out, ref)))


def run(dev, modes=MODES, seed=0, runs=20):
    """The probe on ``dev``.  Returns a dict: ``numerics`` {mode: (max
    error, relative error) against host_reference, or None for bandonly
    where a box does not fit}; ``thetas``, per theta a dict with the
    probe's fit rate (``probe_fit``), kernel 1's time on bf16 x, the probe's
    partner (``kernel1_ms``), and on the same values in fp32, which stores
    fp32 as this kernel does (``kernel1_fp32_ms``), this kernel with nothing
    staged (blockwhen at a budget of one row, ``unstaged_ms``),
    F.grid_sample's on an fp32 source repeated per grid, made before the
    timed call (``library_ms``) and inside it from rows3
    (``library_relayout_ms``), ``bound_ms`` and ``bound_by``, the
    inputs (``args``) and ``modes`` {mode: ``ms``, ``staged`` (share of
    boxes that fit),
    ``flags_match`` (the card's choice equals staged_flags'), ``vs_kernel1``
    (max|err|, max|ref|, bit for bit) or None where bandonly is wrong}."""
    timer = common.timer(dev)
    shape, spatial = (D, H, W, C), (D, H, W)
    x_np, rows3_np, coords = inputs(seed)
    rows3 = torch.from_numpy(rows3_np).bfloat16().to(dev)
    cuda = dev.type == "cuda"

    def warp(cg, mode, staged=None, budget=BUDGET):
        if cuda:
            return banded_warp_cuda(rows3[:cg[0].shape[0]], *cg, shape, mode, VB, budget, staged)
        return banded_warp_plain(rows3[:cg[0].shape[0]], *cg, shape, mode, VB, budget)

    def fits_all(cg_np, mode):
        return bool(staged_flags(cg_np[1], cg_np[2], D, H, VB, BUDGET, mode).all())

    first = [a[:2] for a in coords(3.0)]                             # n = 0..1
    ref = host_reference(x_np[:2], *first)
    small = [torch.from_numpy(a).to(dev) for a in first]
    numerics = {}
    for mode in modes:
        got = warp(small, mode).cpu().numpy()
        err = float(np.abs(got - ref).max())
        numerics[mode] = ((err, err / max(1e-6, float(np.abs(ref).max())))
                          if mode != "bandonly" or fits_all(first, mode) else None)

    x_bf = rows3_to_x(rows3, shape)
    x_f32 = x_bf.float()
    thetas = []
    for theta in THETAS:
        cg_np = coords(theta)
        cg = [torch.from_numpy(a).to(dev) for a in cg_np]
        kernel1 = fast_warp.warp_multi_pixel(x_f32, *cg, spatial).reshape(N, -1, K1 * C)

        def per_grid(rows):          # F.grid_sample's source: x in fp32, once per grid
            return (rows3_to_x(rows, shape).float().permute(0, 4, 1, 2, 3)[:, None]
                    .expand(N, K1, C, D, H, W).reshape(N * K1, C, D, H, W).contiguous())

        src = per_grid(rows3)
        grid = torch.stack([a * (2.0 / (s - 1)) - 1.0 for a, s in zip(cg, (W, H, D))], -1)
        grid = grid.reshape(N * K1, D, H, W, 3)

        def library(source):
            return F.grid_sample(source, grid, mode="bilinear", padding_mode="zeros",
                                 align_corners=True)

        row = dict(theta=theta, probe_fit=probe_fit_rate(cg_np[2], D, VB, ZB),
                   kernel1_ms=timer(lambda: fast_warp.warp_multi_pixel(x_bf, *cg, spatial), runs),
                   kernel1_fp32_ms=timer(lambda: fast_warp.warp_multi_pixel(x_f32, *cg, spatial),
                                         runs),
                   library_ms=timer(lambda: library(src), runs),
                   library_relayout_ms=timer(lambda: library(per_grid(rows3)), runs),
                   # one row never holds a box: every block gathers from L2
                   unstaged_ms=timer(lambda: warp(cg, "blockwhen", budget=1), runs),
                   args=(rows3, *cg, shape), modes={})
        # 8 corners x (C multiply-adds + the weights) per sample
        row["bound_ms"], row["bound_by"] = common.bound_ms(
            rows3.numel() * 2 + 3 * cg[0].numel() * 4 + kernel1.numel() * 4,
            cg[0].numel() * 8 * (2 * C + 12))
        del src
        for mode in modes:
            host = staged_flags(cg_np[1], cg_np[2], D, H, VB, BUDGET, mode)
            staged = (torch.zeros(host.shape, dtype=torch.uint8, device=dev) if cuda else None)
            out = warp(cg, mode, staged)
            card = host if staged is None else staged.bool().cpu().numpy()
            exact = mode != "bandonly" or bool(host.all())
            row["modes"][mode] = dict(
                ms=timer(lambda: warp(cg, mode), runs), staged=float(card.mean()),
                flags_match=bool(np.array_equal(card, host)),
                vs_kernel1=_agreement(out, kernel1) if exact else None)
        thetas.append(row)
    return dict(numerics=numerics, thetas=thetas)


def main(argv=None):
    p = common.parser(__doc__)
    p.add_argument("--mode", default="banded", choices=MODES,
                   help="the probe's MODE: stage per (block, k), per block, or always")
    args = p.parse_args(argv)
    dev = common.device(args.device)
    print(common.card(dev))
    r = run(dev, modes=(args.mode,))
    num = r["numerics"][args.mode]
    print(f"{args.mode} numerics vs exact host: "
          + (f"max abs {num[0]:.3e}  rel {num[1]:.3e} (fp32 sums over the bf16 source)"
             if num else "not checked (a box exceeds the budget: bandonly is wrong there)"))
    for t in r["thetas"]:
        m = t["modes"][args.mode]
        k1 = m["vs_kernel1"]
        agree = ("not checked (bandonly, a box exceeds the budget)" if k1 is None else
                 f"max|err| {k1[0]:.3e} (max|ref| {k1[1]:.3f}), bit for bit "
                 f"{'yes' if k1[2] else 'no'}")
        print(f"theta={t['theta']:5.1f}  probe fit rate {t['probe_fit']:.2f} (ZB={ZB})   "
              f"staged {m['staged']:.2f} (budget {BUDGET} rows)   kernel 1 (bf16) "
              f"{t['kernel1_ms']:.4f} ms   {args.mode} {m['ms']:.4f} ms   speedup "
              f"{t['kernel1_ms'] / m['ms']:4.2f}x ({common.time_label(dev)}); bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}), F.grid_sample {t['library_ms']:.4f} ms "
              f"(fp32 source per grid made before the call; {t['library_relayout_ms']:.4f} ms "
              f"with it made from rows3 inside)")
        print(f"theta={t['theta']:5.1f}  vs kernel 1 in fp32: {agree}; kernel 1 on fp32 x "
              f"(fp32 stores, as here) {t['kernel1_fp32_ms']:.4f} ms; nothing staged "
              f"(budget 1 row) {t['unstaged_ms']:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
