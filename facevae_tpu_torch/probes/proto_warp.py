"""Probe 7: the trilinear warp core on a transposed table (port of
tools/proto_pallas_warp.py).

    python -m facevae_tpu_torch.probes.proto_warp [--device cpu]

Samples one volume [D=16, H=64, W=64, C=4], held as the probe's table volT
[C*W, D*H] fp32 (row c*W + x, column z*H + y; bf16-rounded values), at
P = 65536 unnormalized coordinates (zeros padding) -> [P, C] fp32.  On the
card csrc/probe_warp.cu re-lays the table channel-last (probe_relayout_kernel)
and samples that (probe_warp_kernel), both inside the call.  It prints, as
the TPU probe does, the error against the probe's oracle (a numpy trilinear
sample of the fp32 volume, so the bf16 table costs ~1e-2), the same against
the bf16-rounded volume (the exact answer), and the one-hot-matmul
formulation's error and time (the probe's comparison partner); then the
bound and F.grid_sample's time on the same samples.
"""
from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch
import torch.nn.functional as F

from facevae_tpu_torch.ops.fast_warp import _sample
from facevae_tpu_torch import kernels
from facevae_tpu_torch.probes import common

D, H, W, C = 16, 64, 64, 4
P = 1 << 16                     # voxels per call
RELAYOUT_ZY, RELAYOUT_X = 32, 16  # csrc/probe_warp.cu: a relayout block's tile of volT
THREADS = 256                   # the sampling kernel's block
launches = {"probe_warp": 0, "probe_warp_plain": 0}


def reset_launch_counts():
    for k in launches:
        launches[k] = 0


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float().numpy()


def inputs(seed=0):
    """numpy, from RandomState(seed): the volume vol [D,H,W,C] fp32
    (standard normal), its bf16 row matrix rows [D*H, C*W] (C-major: column
    c*W + x), the probe's table volT = rows.T [C*W, D*H] fp32, and the
    coordinates gx, gy, gz [P] uniform over [-1.5, size + 0.5]."""
    rs = np.random.RandomState(seed)
    vol = rs.randn(D, H, W, C).astype(np.float32)
    rows = _bf16(vol.transpose(0, 1, 3, 2).reshape(D * H, C * W))
    coords = [rs.uniform(-1.5, size + 0.5, P).astype(np.float32) for size in (W, H, D)]
    return vol, rows, np.ascontiguousarray(rows.T), *coords


def ref_trilinear(vol, gx, gy, gz):
    """The probe's oracle (numpy, zeros padding, unnormalized coordinates):
    vol [D,H,W,C], gx/gy/gz [P] -> [P, C]."""
    d, h, w, c = vol.shape
    out = np.zeros((gx.shape[0], c), np.float32)
    x0 = np.floor(gx).astype(int)
    tx = gx - x0
    y0 = np.floor(gy).astype(int)
    ty = gy - y0
    z0 = np.floor(gz).astype(int)
    tz = gz - z0
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                zc, yc, xc = z0 + dz, y0 + dy, x0 + dx
                val = ((zc >= 0) & (zc < d) & (yc >= 0) & (yc < h) & (xc >= 0) & (xc < w))
                zi, yi, xi = np.clip(zc, 0, d - 1), np.clip(yc, 0, h - 1), np.clip(xc, 0, w - 1)
                v = vol[zi, yi, xi, :] * val[:, None]
                wgt = (np.where(dz, tz, 1 - tz) * np.where(dy, ty, 1 - ty)
                       * np.where(dx, tx, 1 - tx))
                out += v * wgt[:, None]
    return out


def _check(volT, gx, gy, gz, shape):
    d, h, w, c = shape
    if volT.dim() != 2 or tuple(volT.shape) != (c * w, d * h):
        raise ValueError(f"volT must be [C*W, D*H] = [{c * w}, {d * h}], got {tuple(volT.shape)}")
    if gx.dim() != 2 or gx.shape[0] != 1 or gy.shape != gx.shape or gz.shape != gx.shape:
        raise ValueError(f"gx/gy/gz must be [1, P], got {tuple(gx.shape)} {tuple(gy.shape)} "
                         f"{tuple(gz.shape)}")


def proto_warp_plain(volT, gx, gy, gz, shape):
    """The kernel's plain version: the port's fp32 8-corner gather
    (ops/fast_warp.py) on the volume behind volT.  shape = (D, H, W, C)."""
    _check(volT, gx, gy, gz, shape)
    launches["probe_warp_plain"] += 1
    d, h, w, c = shape
    vol = volT.reshape(c, w, d, h).permute(2, 3, 1, 0)                 # [D,H,W,C]
    p = gx.shape[1]
    out = _sample(vol[None], *(g.reshape(1, 1, p) for g in (gx, gy, gz)))
    return out[0].to(volT.dtype)


def launch_plan(shape, p):
    """The two launches of facevae_probe_warp (csrc/probe_warp.cu): the
    relayout's blocks (``relayout_tiles`` = (D*H tiles, W tiles) of
    RELAYOUT_ZY columns by RELAYOUT_X rows of each channel, one block each,
    the (z, y) tiles fastest in a 1D grid) and the sampler's
    (``sample_blocks`` of THREADS points).  Raises ValueError where an index
    or the grid passes 32 bits."""
    d, h, w, c = shape
    if max(c * w * d * h, p) >= 2 ** 31:
        raise ValueError(f"volT or P={p} exceeds the kernel's 32-bit indices")
    tiles = (-(-d * h // RELAYOUT_ZY), -(-w // RELAYOUT_X))
    return dict(relayout_tiles=tiles, relayout_blocks=tiles[0] * tiles[1],
                sample_blocks=-(-p // THREADS))


def proto_warp_cuda(volT, gx, gy, gz, shape):
    """Launch csrc/probe_warp.cu on CUDA tensors: probe_relayout_kernel
    re-lays volT into a channel-last scratch [D*H, W, C] (allocated here),
    probe_warp_kernel samples it.  volT fp32 [C*W, D*H], gx/gy/gz fp32
    [1, P], all contiguous, C in {1, 2, 4}; raises on anything else."""
    _check(volT, gx, gy, gz, shape)
    if not volT.is_cuda:
        raise ValueError(f"probe_warp kernel needs CUDA tensors, got {volT.device}")
    common.check_tensor("probe_warp", "volT", volT, torch.float32, volT.device)
    for name, g in (("gx", gx), ("gy", gy), ("gz", gz)):
        common.check_tensor("probe_warp", name, g, torch.float32, volT.device)
    d, h, w, c = shape
    p = gx.shape[1]
    if c not in (1, 2, 4):
        raise ValueError(f"probe_warp kernel takes C in (1, 2, 4), got {c}")
    launch_plan(shape, p)
    out = torch.empty((p, c), dtype=torch.float32, device=volT.device)
    if p:
        vol = torch.empty(volT.numel(), dtype=torch.float32, device=volT.device)
        fn = kernels.function("probe_warp", "facevae_probe_warp",
                              [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        with torch.cuda.device(volT.device):
            kernels.launch(launches, "probe_warp", fn, volT.data_ptr(), vol.data_ptr(),
                           gx.data_ptr(), gy.data_ptr(), gz.data_ptr(), out.data_ptr(), d, h, w,
                           c, p, common.stream(volT))
    return out


def proto_warp(volT, gx, gy, gz, shape):
    """The trilinear sample [P, C] of the volume behind volT at gx/gy/gz
    [1, P]: the kernel for CUDA tensors, the plain version for CPU ones."""
    fn = proto_warp_cuda if common.on_cuda("proto_warp", volT) else proto_warp_plain
    return fn(volT, gx, gy, gz, shape)


def onehot_warp(rows, gx, gy, gz, shape):
    """The probe's comparison partner, the one-hot formulation of the XLA
    path: the (z, y) corner weights as a bf16 matrix A [P, D*H] times rows
    [D*H, C*W] bf16, then the x weights and a sum over x.  gx/gy/gz [P]."""
    d, h, w, c = shape
    p = gx.shape[0]
    x0, y0, z0 = torch.floor(gx), torch.floor(gy), torch.floor(gz)
    tx, ty, tz = gx - x0, gy - y0, gz - z0
    iota_r = torch.arange(d * h, device=rows.device)
    A = torch.zeros(p, d * h, dtype=torch.bfloat16, device=rows.device)
    zero = torch.zeros((), dtype=torch.bfloat16, device=rows.device)
    for dz in (0, 1):
        for dy in (0, 1):
            zc, yc = z0 + dz, y0 + dy
            valid = (zc >= 0) & (zc <= d - 1) & (yc >= 0) & (yc <= h - 1)
            r = zc.clamp(0, d - 1).long() * h + yc.clamp(0, h - 1).long()
            hit = (iota_r == r[:, None]) & valid[:, None]
            wzy = (tz if dz else 1.0 - tz) * (ty if dy else 1.0 - ty)
            A = A + torch.where(hit, wzy[:, None].bfloat16(), zero)
    S = (A @ rows).float()                                            # [P, C*W]
    iota_x = torch.arange(c * w, device=rows.device) % w
    x0i = x0.long()[:, None]
    w0 = ((iota_x == x0i) & ((x0 >= 0) & (x0 <= w - 1))[:, None]).float()
    w1 = ((iota_x == x0i + 1) & ((x0 + 1 >= 0) & (x0 + 1 <= w - 1))[:, None]).float()
    wx = (1.0 - tx)[:, None] * w0 + tx[:, None] * w1
    return (S * wx).reshape(p, c, w).sum(-1)


def run(dev, seed=0, runs=20):
    """The probe on ``dev``: a dict with the kernel's max error against the
    probe's oracle on the fp32 volume (``err``) and on the bf16-rounded
    volume (``err_exact``), the one-hot partner's (``onehot_err``); ``ms``,
    ``onehot_ms``, ``library_ms`` (F.grid_sample, 3D, on the same samples
    normalized outside the timed call, from a contiguous [1,C,D,H,W] copy of
    the table made outside it too) and ``library_view_ms`` (the same from
    volT's own permuted view, no copy: the kernel's inputs), ``bound_ms`` and
    ``bound_by`` (table,
    coordinates and output over 3.35 TB/s, against the fp32 operations over
    67 TFLOP/s) and the inputs (``args``)."""
    timer = common.timer(dev)
    shape = (D, H, W, C)
    vol, rows_np, volT_np, *coords = inputs(seed)
    volT = torch.from_numpy(volT_np).to(dev)
    g = [torch.from_numpy(a).reshape(1, P).to(dev) for a in coords]
    got = proto_warp(volT, *g, shape).cpu().numpy()
    exact = ref_trilinear(_bf16(vol), *coords)
    rows = torch.from_numpy(rows_np).bfloat16().to(dev)
    flat = [a[0] for a in g]
    onehot = onehot_warp(rows, *flat, shape).cpu().numpy()
    want = ref_trilinear(vol, *coords)
    view = volT.reshape(C, W, D, H).permute(0, 2, 3, 1)[None]                # [1,C,D,H,W]
    src = view.contiguous()
    grid = torch.stack([a * (2.0 / (s - 1)) - 1.0 for a, s in zip(flat, (W, H, D))], -1)
    grid = grid.reshape(1, 1, 1, P, 3)

    def library(source):
        return F.grid_sample(source, grid, mode="bilinear", padding_mode="zeros",
                             align_corners=True)

    # 8 corners x (C multiply-adds + the weights) per sample
    bound_ms, bound_by = common.bound_ms(volT.numel() * 4 + 3 * P * 4 + P * C * 4,
                                         P * 8 * (2 * C + 12))
    return dict(err=float(np.abs(got - want).max()), err_exact=float(np.abs(got - exact).max()),
                scale=float(np.abs(exact).max()), onehot_err=float(np.abs(onehot - want).max()),
                ms=timer(lambda: proto_warp(volT, *g, shape), runs),
                onehot_ms=timer(lambda: onehot_warp(rows, *flat, shape), runs),
                library_ms=timer(lambda: library(src), runs),
                library_view_ms=timer(lambda: library(view), runs),
                bound_ms=bound_ms, bound_by=bound_by, args=(volT, *g, shape))


def main(argv=None):
    args = common.parser(__doc__).parse_args(argv)
    dev = common.device(args.device)
    print(common.card(dev))
    r = run(dev)
    print(f"probe_warp err vs oracle: {r['err']:.4f} (bf16 table => ~1e-2 expected); vs the "
          f"bf16-rounded volume: {r['err_exact']:.3e} (max|ref| {r['scale']:.3f})")
    print(f"onehot err vs oracle: {r['onehot_err']:.4f}")
    print(f"probe_warp: {r['ms']:.4f} ms   onehot-matmul: {r['onehot_ms']:.4f} ms   speedup "
          f"{r['onehot_ms'] / r['ms']:.2f}x   ({P} voxels, CW={C * W}; "
          f"{common.time_label(dev)}); bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}), "
          f"F.grid_sample {r['library_ms']:.4f} ms on a contiguous copy of the table, "
          f"{r['library_view_ms']:.4f} ms on volT's own permuted view")
    return 0


if __name__ == "__main__":
    sys.exit(main())
