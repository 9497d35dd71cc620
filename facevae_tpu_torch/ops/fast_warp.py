"""Trilinear warps and their gradients (port of facevae_tpu/ops/fast_warp.py).

Semantics: grid_sample 3D with align_corners=True and zeros padding.  Two
ops, with the JAX package's layouts:

  warp_multi_pixel(x [N,D,H,W,C], cgx/cgy/cgz [N,K1,NV], spatial)
      -> [N,Do,Ho,Wo,K1*C], k-major (channel k*C + c is grid k's sample of c);
      per-axis PIXEL coordinate planes.
  grid_sample_3d_fast(x [N,D,H,W,C], grid [N*gps,Do,Ho,Wo,3], gps)
      -> [N*gps,Do,Ho,Wo,C], grid-major; a NORMALIZED [-1,1] grid, unnormalized
      as the JAX package's _coords does ((g + 1) * 0.5 * (size - 1), fp32);
      grid g samples source g // gps.

and three callers of them: warp_single (one grid per source: the single-grid
op at fp32, the multi-grid op at bf16, as the JAX package dispatches on its
chip), grid_sample_3d_multi (K1 normalized grids through warp_multi_pixel)
and, in ops/motion.py, the reference-form create_deformed_source_image.

Both ops are differentiable (torch.autograd.Function).  Their backwards
return dx in x's dtype, summed over every grid that reads a source, and the
coordinate cotangents: pixel units for warp_multi_pixel, normalized units
(already scaled by (size-1)/2) in grid's dtype for grid_sample_3d_fast.

Dispatch is by the device of ``x`` alone: a CUDA tensor goes through the
hand-written kernels or the call raises; a CPU tensor goes through their
plain PyTorch versions.

  op                  half            kernel                      plain version
  warp_multi_pixel    forward         csrc/warp_fwd.cu            warp_multi_pixel_plain
                      d coordinates   csrc/warp_bwd.cu (dgrid)    warp_multi_pixel_bwd_plain
                      d source        csrc/warp_bwd.cu (dx)       warp_multi_pixel_bwd_plain
  grid_sample_3d_fast forward         csrc/warp_grid.cu (fwd)     grid_sample_3d_plain
                      d grid          csrc/warp_grid.cu (dgrid)   grid_sample_3d_bwd_plain
                      d source        csrc/warp_grid.cu (dx)      grid_sample_3d_bwd_plain

A backward skips the half that autograd does not need.  By default the dx
kernels add with fp32 atomics, so the last bits of dx vary from run to run.
With torch.use_deterministic_algorithms(True) (warn_only too) the dx
kernels sum in fixed point instead: each contribution rounded once to an int64 at a
scale 2^s (``dx_scale_exponent``, from max|gout| on the card, no host sync)
and added with integer atomics, whose order does not change the bits, then
converted once to fp32 (non-finite contributions by flags, as IEEE adds
them).  Its launches count under ``warp_bwd_dx_det`` / ``grid_bwd_dx_det``.
It costs an int64 buffer twice the size of dx and scalar 64-bit atomics
(PERF.md §6 has its times).  The JAX package's
z-banding, channel grouping and VMEM planners exist for the TPU's memory and
matrix unit and are not ported.  The multi-grid forward at K1 > 1 runs one
block per (n, tile of output voxels) that writes its k-major output tile
through shared memory (csrc/warp_fwd.cu).

Under remat (facevae_tpu_torch/remat.py) a forward's output is kept for
the recompute, as the JAX package saves its "warp_out" outputs: a remat
step launches each forward kernel as often as a plain step.

Each path counts its launches in ``launches`` (plain integers), so a run can
show which path the served or trained graph took.  The two forward
wrappers also keep the grid their last launch used, as the launch code
wrote it back, in ``launch_grids``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from facevae_tpu_torch import remat

launches = {"warp_fwd": 0, "warp_fwd_plain": 0,
            "warp_bwd_dgrid": 0, "warp_bwd_dgrid_plain": 0,
            "warp_bwd_dx": 0, "warp_bwd_dx_plain": 0, "warp_bwd_dx_det": 0,
            "grid_fwd": 0, "grid_fwd_plain": 0,
            "grid_bwd_dgrid": 0, "grid_bwd_dgrid_plain": 0,
            "grid_bwd_dx": 0, "grid_bwd_dx_plain": 0, "grid_bwd_dx_det": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535
_MAX_GRID_X = 2 ** 31 - 1


# forward kernel name -> (grid x, grid y, grid z, threads a block) of its
# wrapper's last launch, as the launch code wrote them back
launch_grids = {}


def reset_launch_counts():
    for k in launches:
        launches[k] = 0


def _check(x, cgx, cgy, cgz, spatial):
    if x.dim() != 5:
        raise ValueError(f"x must be [N,D,H,W,C], got {tuple(x.shape)}")
    N = x.shape[0]
    if cgx.dim() != 3 or cgx.shape[0] != N:
        raise ValueError(f"coordinates must be [N,K1,NV], got {tuple(cgx.shape)}")
    if cgy.shape != cgx.shape or cgz.shape != cgx.shape:
        raise ValueError("cgx/cgy/cgz shapes differ: "
                         f"{tuple(cgx.shape)} {tuple(cgy.shape)} {tuple(cgz.shape)}")
    if math.prod(spatial) != cgx.shape[2]:
        raise ValueError(f"spatial {tuple(spatial)} does not hold NV={cgx.shape[2]} voxels")


def _check_grid(x, grid, gps):
    if x.dim() != 5:
        raise ValueError(f"x must be [N,D,H,W,C], got {tuple(x.shape)}")
    if grid.dim() != 5 or grid.shape[-1] != 3 or grid.shape[0] != x.shape[0] * gps:
        raise ValueError(f"grid must be [N*gps,Do,Ho,Wo,3] = [{x.shape[0]}*{gps},...,3], "
                         f"got {tuple(grid.shape)}")


def _acc_dtype(x):
    """The plain versions sum in fp32 (fp64 for fp64 inputs: gradcheck)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _corners(x, cgx, cgy, cgz):
    """The 8 trilinear corners of every (n, k, voxel), as the kernels walk
    them: yields (flat index [N, K1*NV] long, weight w, and dw/dg for the
    three axes, each [N, K1*NV] in the summing dtype).  Corners outside the
    volume (also for NaN / inf coordinates) get weight 0 and index 0."""
    N, D, H, W, _ = x.shape
    K1, NV = cgx.shape[1], cgx.shape[2]
    g = [c.to(_acc_dtype(x)).reshape(N, K1 * NV) for c in (cgx, cgy, cgz)]
    floors = [torch.floor(c) for c in g]
    fracs = [c - f for c, f in zip(g, floors)]
    sizes = (W, H, D)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                ws, valid, idx = [], torch.ones_like(g[0], dtype=torch.bool), []
                for a, d in enumerate((dx, dy, dz)):
                    j = floors[a] + d
                    valid &= (j >= 0) & (j <= sizes[a] - 1)
                    ws.append(fracs[a] if d else 1.0 - fracs[a])
                    idx.append(j)
                signs = [1.0 if d else -1.0 for d in (dx, dy, dz)]
                wx, wy, wz = (torch.where(valid, w, 0.0) for w in ws)
                jx, jy, jz = (torch.where(valid, j, 0.0).long() for j in idx)
                yield ((jz * H + jy) * W + jx, wx * wy * wz,
                       (signs[0] * wy * wz, signs[1] * wx * wz, signs[2] * wx * wy))


def _sample(x, cgx, cgy, cgz):
    """The 8-corner gather of x [N,D,H,W,C] at pixel coordinates [N,K1,NV]:
    [N, K1*NV, C] in the summing dtype, rows in (k, v) order."""
    N, D, H, W, C = x.shape
    rows = cgx.shape[1] * cgx.shape[2]
    src = x.to(_acc_dtype(x)).reshape(N, D * H * W, C)
    out = torch.zeros(N, rows, C, dtype=src.dtype, device=x.device)
    for flat, w, _ in _corners(x, cgx, cgy, cgz):
        out += w[..., None] * torch.gather(src, 1, flat[..., None].expand(N, rows, C))
    return out


def _sample_bwd(x, cgx, cgy, cgz, g, need_dx, need_dgrid):
    """_sample's two cotangents for g [N, K1*NV, C] in the summing dtype:
    (dx [N,D,H,W,C] or None, [dgx, dgy, dgz] each [N, K1*NV] in pixel units
    or None), both in the summing dtype."""
    N, D, H, W, C = x.shape
    rows = cgx.shape[1] * cgx.shape[2]
    src = x.to(g.dtype).reshape(N, D * H * W, C)
    dsrc = torch.zeros_like(src) if need_dx else None
    dg = [torch.zeros(N, rows, dtype=g.dtype, device=x.device)
          for _ in range(3)] if need_dgrid else None
    for flat, w, dw in _corners(x, cgx, cgy, cgz):
        index = flat[..., None].expand(N, rows, C)
        if need_dgrid:
            dot = (torch.gather(src, 1, index) * g).sum(-1)
            for a in range(3):
                dg[a] += dw[a] * dot
        if need_dx:
            dsrc.scatter_add_(1, index, w[..., None] * g)
    return (dsrc.reshape(x.shape) if need_dx else None), dg


def warp_multi_pixel_plain(x, cgx, cgy, cgz, spatial):
    """The multi-grid forward kernel's plain version: an fp32 8-corner
    gather, result in x's dtype.  Same contract as ``warp_multi_pixel``."""
    _check(x, cgx, cgy, cgz, spatial)
    launches["warp_fwd_plain"] += 1
    N, C = x.shape[0], x.shape[-1]
    K1, NV = cgx.shape[1], cgx.shape[2]
    out = _sample(x, cgx, cgy, cgz).reshape(N, K1, NV, C).permute(0, 2, 1, 3)
    return out.reshape(N, *spatial, K1 * C).to(x.dtype)


def _gout_k_major(gout, dtype, N, K1, NV, C):
    """gout [N, *spatial, K1*C] -> [N, K1*NV, C], rows in (k, v) order."""
    return gout.to(dtype).reshape(N, NV, K1, C).permute(0, 2, 1, 3).reshape(N, K1 * NV, C)


def warp_multi_pixel_bwd_plain(x, cgx, cgy, cgz, gout, spatial, need_dx=True,
                               need_dgrid=True):
    """The multi-grid backward kernels' plain version.  gout
    [N,*spatial,K1*C] is the cotangent of the forward's output.  Returns (dx
    in x's dtype or None, (dgx, dgy, dgz) [N,K1,NV] in pixel units, in the
    coordinates' dtype, or None); sums in fp32."""
    _check(x, cgx, cgy, cgz, spatial)
    N, C = x.shape[0], x.shape[-1]
    K1, NV = cgx.shape[1], cgx.shape[2]
    g = _gout_k_major(gout, _acc_dtype(x), N, K1, NV, C)
    dsrc, dg = _sample_bwd(x, cgx, cgy, cgz, g, need_dx, need_dgrid)
    dx = dgrid = None
    if need_dx:
        launches["warp_bwd_dx_plain"] += 1
        dx = dsrc.to(x.dtype)
    if need_dgrid:
        launches["warp_bwd_dgrid_plain"] += 1
        dgrid = tuple(d.reshape(N, K1, NV).to(cgx.dtype) for d in dg)
    return dx, dgrid


def _grid_pixels(x, grid, gps):
    """A normalized grid [N*gps,Do,Ho,Wo,3] -> pixel coordinates (gx, gy, gz),
    each [N, gps, Do*Ho*Wo] in the summing dtype: the JAX package's _coords,
    (g + 1) * 0.5 * (size - 1)."""
    N, D, H, W, _ = x.shape
    g = grid.to(_acc_dtype(x)).reshape(N, gps, -1, 3)
    return tuple((g[..., a] + 1.0) * 0.5 * (size - 1) for a, size in enumerate((W, H, D)))


def grid_sample_3d_plain(x, grid, grids_per_source=1):
    """The single-grid forward kernel's plain version: an fp32 8-corner
    gather, result in x's dtype.  Same contract as ``grid_sample_3d_fast``."""
    _check_grid(x, grid, grids_per_source)
    launches["grid_fwd_plain"] += 1
    out = _sample(x, *_grid_pixels(x, grid, grids_per_source))
    return out.reshape(*grid.shape[:4], x.shape[-1]).to(x.dtype)


def grid_sample_3d_bwd_plain(x, grid, gout, grids_per_source=1, need_dx=True,
                             need_dgrid=True):
    """The single-grid backward kernels' plain version.  gout
    [N*gps,Do,Ho,Wo,C] is the cotangent of the forward's output.  Returns
    (dx in x's dtype, summed over the gps grids of each source, or None;
    dgrid like grid, in normalized units and grid's dtype, or None); sums in
    fp32."""
    _check_grid(x, grid, grids_per_source)
    N, D, H, W, C = x.shape
    g = gout.to(_acc_dtype(x)).reshape(N, -1, C)
    dsrc, dg = _sample_bwd(x, *_grid_pixels(x, grid, grids_per_source), g, need_dx,
                           need_dgrid)
    dx = dgrid = None
    if need_dx:
        launches["grid_bwd_dx_plain"] += 1
        dx = dsrc.to(x.dtype)
    if need_dgrid:
        launches["grid_bwd_dgrid_plain"] += 1
        dgrid = torch.stack([d * ((size - 1) * 0.5) for d, size in zip(dg, (W, H, D))], -1)
        dgrid = dgrid.reshape(grid.shape).to(grid.dtype)
    return dx, dgrid


_GRID_OUT = ctypes.POINTER(ctypes.c_uint)
_SIGNATURES = {
    # name: (library, C symbol, argtypes)
    "warp_fwd": ("warp_fwd", "facevae_warp_fwd",
                 [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p, _GRID_OUT]),
    "warp_bwd_dgrid": ("warp_bwd", "facevae_warp_bwd_dgrid",
                       [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p]),
    "warp_bwd_dx": ("warp_bwd", "facevae_warp_bwd_dx",
                    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]),
    "warp_bwd_dx_det": ("warp_bwd", "facevae_warp_bwd_dx_det",
                        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p]),
    "grid_fwd": ("warp_grid", "facevae_grid_fwd",
                 [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p, _GRID_OUT]),
    "grid_bwd_dgrid": ("warp_grid", "facevae_grid_bwd_dgrid",
                       [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]),
    "grid_bwd_dx": ("warp_grid", "facevae_grid_bwd_dx",
                    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p]),
    "grid_bwd_dx_det": ("warp_grid", "facevae_grid_bwd_dx_det",
                        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]),
}


def _check_x_cuda(name, x):
    if not x.is_cuda:
        raise ValueError(f"{name} kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} kernel takes fp32 or bf16 x, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} kernel needs a contiguous channel-last x")


def _check_launch_grid(rows, NV, what):
    """The kernels put rows (N, N*K1 or N*gps) on blockIdx.y and index
    voxels with 32-bit ints."""
    if rows > _MAX_GRID_Y:
        raise ValueError(f"{what}={rows} exceeds the kernel's grid limit {_MAX_GRID_Y}")
    if NV >= 2 ** 31:
        raise ValueError(f"NV={NV} voxels exceeds the kernel's 32-bit voxel index")


def _dgrid_lanes(C, cpt, item):
    """The multi-grid dgrid kernel's threads per (n, k, v): the power of two
    >= C / cpt / vecs, at least 1, at most 32, where a lane holds vecs = 2
    cotangent vectors of fp32 (item 4) or 4 of bf16
    (csrc/warp_bwd.cu:dgrid_lanes, dgrid_vecs)."""
    per_lane = -(-(C // cpt) // (2 if item == 4 else 4))
    lanes = 1
    while lanes < per_lane and lanes < 32:
        lanes *= 2
    return lanes


def _check_dgrid_launch(N, K1, NV, lanes):
    """The multi-grid dgrid kernel's grid: (voxel blocks of 256 / lanes
    voxels) * K1 on blockIdx.x (at most 2^31 - 1), N on blockIdx.y."""
    _check_launch_grid(N, NV, "N")
    blocks = -(-NV * lanes // 256) * K1
    if blocks > _MAX_GRID_X:
        raise ValueError(f"{blocks} blocks (NV={NV} voxels at {lanes} lanes each, K1={K1}) "
                         f"exceed the kernel's grid limit {_MAX_GRID_X}")


def _check_source_voxels(x):
    """The single-grid forward and the dx kernels index the source's voxels
    with 32-bit ints."""
    if math.prod(x.shape[1:4]) >= 2 ** 31:
        raise ValueError(f"a source of {tuple(x.shape[1:4])} voxels exceeds the kernel's "
                         "32-bit voxel index")


_GRID_FWD_THREADS = 256        # threads a block of the single-grid forward
_GRID_FWD_VOXELS_PER_THREAD = 4   # voxels a thread of its voxel kernel


def _grid_fwd_plan(C, cpt, NV, G):
    """The single-grid forward's launch (csrc/warp_grid.cu:facevae_grid_fwd):
    its kernel and the grid it reports.  "voxel" where C == cpt (one channel
    vector a voxel): a thread per 4 voxels, (ceil(NV / 1024), G, 1, 256);
    else "table" (a block's corner table in shared memory, then its
    (voxel, channel vector) items): 256 voxels a block, (ceil(NV / 256), G,
    1, 256).  Raises where the table kernel's 32-bit item index, 256 * C /
    cpt, would overflow."""
    if _GRID_FWD_THREADS * (C // cpt) >= 2 ** 31:
        raise ValueError(f"C={C} channels in vectors of {cpt} exceed the forward kernel's "
                         "32-bit item index")
    kernel = "voxel" if C == cpt else "table"
    per_block = _GRID_FWD_THREADS * (_GRID_FWD_VOXELS_PER_THREAD if kernel == "voxel" else 1)
    return kernel, (-(-NV // per_block), G, 1, _GRID_FWD_THREADS)


def _check_cuda(name, x, cgx, cgy, cgz, spatial):
    """The checks every multi-grid kernel wrapper makes before it launches;
    each launch checks its own grid."""
    _check(x, cgx, cgy, cgz, spatial)
    _check_x_cuda(name, x)
    for cname, c in (("cgx", cgx), ("cgy", cgy), ("cgz", cgz)):
        if c.device != x.device or c.dtype != torch.float32 or not c.is_contiguous():
            raise ValueError(f"{cname} must be a contiguous fp32 tensor on {x.device}, "
                             f"got {c.dtype} on {c.device}")


def _check_grid_cuda(name, x, grid, gps):
    """The checks every single-grid kernel wrapper makes before it launches.
    The grid must already be fp32, as the JAX package computes it: the
    wrapper converts nothing."""
    _check_grid(x, grid, gps)
    _check_x_cuda(name, x)
    if grid.device != x.device or grid.dtype != torch.float32 or not grid.is_contiguous():
        raise ValueError(f"grid must be a contiguous fp32 tensor on {x.device}, "
                         f"got {grid.dtype} on {grid.device}")
    _check_launch_grid(grid.shape[0], math.prod(grid.shape[1:4]), "N*gps")


def _check_gout(gout, shape, x):
    if tuple(gout.shape) != tuple(shape):
        raise ValueError(f"gout must be {tuple(shape)}, got {tuple(gout.shape)}")
    if gout.device != x.device:
        raise ValueError(f"gout lies on {gout.device}, x on {x.device}")


def dx_scale_exponent(gout, count):
    """The deterministic dx's scale 2^s, s an int32 0-dim tensor on gout's
    device (computed there: no host sync).  M = max |finite gout|, count =
    the most samples that can reach one dx element (each through one corner
    of weight <= 1).  With M = mant * 2^e (mant in [0.5, 1)) and
    2^(b-1) < count <= 2^b, s = 62 - b - e gives 2^60 < count * M * 2^s <
    2^62: every int64 partial sum of the rounded contributions stays within
    2^62 in any order, at a resolution 2^-s (M * 2^-42 at MFE, count =
    15 * 65536)."""
    a = gout.detach().abs()
    m = torch.where(torch.isfinite(a), a, 0).amax().float()
    _, e = torch.frexp(m)
    return (62 - (count - 1).bit_length() - e).to(torch.int32)


def _fixed_point_buffers(x, gout, count):
    """The deterministic dx kernels' buffers: the int64 sums and the
    non-finite flags (one int32 word per 8 elements), both zeroed, the scale
    exponent, and the fp32 result."""
    return (torch.zeros(x.shape, dtype=torch.int64, device=x.device),
            torch.zeros((x.numel() + 7) // 8, dtype=torch.int32, device=x.device),
            dx_scale_exponent(gout, count),
            torch.empty(x.shape, dtype=torch.float32, device=x.device))


def _cpt(C, item, *tensors):
    """Channels per 16-byte vector that C and every pointer's alignment allow."""
    cpt = 16 // item
    while cpt > 1 and (C % cpt or any(t.data_ptr() % (cpt * item) for t in tensors)):
        cpt //= 2
    return cpt


def _launch(name, *args):
    from facevae_tpu_torch import kernels
    kernels.launch(launches, name, kernels.function(*_SIGNATURES[name]), *args)


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def warp_multi_pixel_cuda(x, cgx, cgy, cgz, spatial):
    """Launch csrc/warp_fwd.cu on CUDA tensors; raises on anything the
    kernel does not take."""
    _check_cuda("warp_fwd", x, cgx, cgy, cgz, spatial)
    N, D, H, W, C = x.shape
    K1, NV = cgx.shape[1], cgx.shape[2]
    _check_launch_grid(N * K1, NV, "N*K1")
    out = torch.empty((N, NV, K1 * C), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out.reshape(N, *spatial, K1 * C)
    cpt = _cpt(C, x.element_size(), x)
    launched = (ctypes.c_uint * 4)()
    with torch.cuda.device(x.device):
        _launch("warp_fwd", x.data_ptr(), cgx.data_ptr(), cgy.data_ptr(), cgz.data_ptr(),
                out.data_ptr(), N, D, H, W, C, K1, NV, _DTYPE_CODES[x.dtype], cpt, _stream(x),
                launched)
    launch_grids["warp_fwd"] = tuple(launched)
    return out.reshape(N, *spatial, K1 * C)


def warp_multi_pixel_bwd_cuda(x, cgx, cgy, cgz, gout, spatial, need_dx=True,
                              need_dgrid=True):
    """Launch csrc/warp_bwd.cu's kernels on CUDA tensors (the dgrid kernel
    if need_dgrid, the dx kernel if need_dx); same contract as
    ``warp_multi_pixel_bwd_plain``.  gout is read in x's dtype; dx is summed
    in an fp32 buffer (fixed point in int64 when
    torch.are_deterministic_algorithms_enabled()) and cast once.  Raises on
    anything the kernels do not take."""
    _check_cuda("warp_bwd", x, cgx, cgy, cgz, spatial)
    N, D, H, W, C = x.shape
    K1, NV = cgx.shape[1], cgx.shape[2]
    _check_gout(gout, (N, *spatial, K1 * C), x)
    gout = gout.to(x.dtype).contiguous()
    cpt = _cpt(C, x.element_size(), x, gout)
    if need_dgrid:
        _check_dgrid_launch(N, K1, NV, _dgrid_lanes(C, cpt, x.element_size()))
    if need_dx:
        _check_launch_grid(N * K1, NV, "N*K1")
        _check_source_voxels(x)
    dtype, stream = _DTYPE_CODES[x.dtype], _stream(x)
    dx = dgrid = None
    with torch.cuda.device(x.device):
        if need_dgrid:
            dgrid = tuple(torch.empty_like(cgx) for _ in range(3))
            if cgx.numel():
                _launch("warp_bwd_dgrid", x.data_ptr(), cgx.data_ptr(), cgy.data_ptr(),
                        cgz.data_ptr(), gout.data_ptr(), *(d.data_ptr() for d in dgrid),
                        N, D, H, W, C, K1, NV, dtype, cpt, stream)
        if need_dx:
            ptrs = (cgx.data_ptr(), cgy.data_ptr(), cgz.data_ptr(), gout.data_ptr())
            if cgx.numel() and torch.are_deterministic_algorithms_enabled():
                acc, flags, s, out = _fixed_point_buffers(x, gout, K1 * NV)
                _launch("warp_bwd_dx_det", *ptrs, acc.data_ptr(), flags.data_ptr(),
                        s.data_ptr(), out.data_ptr(), N, D, H, W, C, K1, NV, dtype,
                        _cpt(C, x.element_size(), gout), stream)
            else:
                out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
                if cgx.numel():
                    _launch("warp_bwd_dx", *ptrs, out.data_ptr(), N, D, H, W, C, K1, NV,
                            dtype, _cpt(C, x.element_size(), gout, out), stream)
            dx = out.to(x.dtype)
    return dx, dgrid


def grid_sample_3d_cuda(x, grid, grids_per_source=1):
    """Launch csrc/warp_grid.cu's forward on CUDA tensors (its voxel or
    table kernel, as ``_grid_fwd_plan`` says); raises on anything the kernel
    does not take."""
    _check_grid_cuda("grid_fwd", x, grid, grids_per_source)
    _check_source_voxels(x)
    D, H, W, C = x.shape[1:]
    G, NV = grid.shape[0], math.prod(grid.shape[1:4])
    out = torch.empty((*grid.shape[:4], C), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    cpt = _cpt(C, x.element_size(), x, out)
    _grid_fwd_plan(C, cpt, NV, G)
    launched = (ctypes.c_uint * 4)()
    with torch.cuda.device(x.device):
        _launch("grid_fwd", x.data_ptr(), grid.data_ptr(), out.data_ptr(),
                D, H, W, C, grids_per_source, G, NV, _DTYPE_CODES[x.dtype], cpt, _stream(x),
                launched)
    launch_grids["grid_fwd"] = tuple(launched)
    return out


def grid_sample_3d_bwd_cuda(x, grid, gout, grids_per_source=1, need_dx=True,
                            need_dgrid=True):
    """Launch csrc/warp_grid.cu's dgrid and / or dx kernels on CUDA tensors;
    same contract as ``grid_sample_3d_bwd_plain``.  gout is read in x's
    dtype; dx is summed in an fp32 buffer (fixed point in int64 when
    torch.are_deterministic_algorithms_enabled()) and cast once.  Raises on
    anything the kernels do not take."""
    _check_grid_cuda("grid_bwd", x, grid, grids_per_source)
    D, H, W, C = x.shape[1:]
    G, NV = grid.shape[0], math.prod(grid.shape[1:4])
    _check_gout(gout, (*grid.shape[:4], C), x)
    if need_dx:
        _check_source_voxels(x)
    gout = gout.to(x.dtype).contiguous()
    dtype, stream = _DTYPE_CODES[x.dtype], _stream(x)
    dx = dgrid = None
    with torch.cuda.device(x.device):
        if need_dgrid:
            dgrid = torch.empty_like(grid)
            if grid.numel():
                cpt = _cpt(C, x.element_size(), x, gout)
                _launch("grid_bwd_dgrid", x.data_ptr(), grid.data_ptr(), gout.data_ptr(),
                        dgrid.data_ptr(), D, H, W, C, grids_per_source, G, NV, dtype, cpt,
                        stream)
        if need_dx:
            shape = (D, H, W, C, grids_per_source, G, NV, dtype)
            if grid.numel() and torch.are_deterministic_algorithms_enabled():
                acc, flags, s, out = _fixed_point_buffers(x, gout, grids_per_source * NV)
                _launch("grid_bwd_dx_det", grid.data_ptr(), gout.data_ptr(), acc.data_ptr(),
                        flags.data_ptr(), s.data_ptr(), out.data_ptr(), *shape,
                        _cpt(C, x.element_size(), gout), stream)
            else:
                out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
                if grid.numel():
                    _launch("grid_bwd_dx", grid.data_ptr(), gout.data_ptr(), out.data_ptr(),
                            *shape, _cpt(C, x.element_size(), gout, out), stream)
            dx = out.to(x.dtype)
    return dx, dgrid


def _on_cuda(op, x):
    """True for a CUDA x, False for a CPU one; raises for any other device."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{op} runs on cuda or cpu, not {x.device}")
    return x.device.type == "cuda"


class _WarpMultiPixel(torch.autograd.Function):
    """warp_multi_pixel with its backward: kernels on CUDA, plain versions
    on the CPU."""

    @staticmethod
    def forward(ctx, x, cgx, cgy, cgz, spatial):
        ctx.save_for_backward(x, cgx, cgy, cgz)
        ctx.spatial = spatial
        return _forward(x, cgx, cgy, cgz, spatial)

    @staticmethod
    def backward(ctx, gout):
        x, cgx, cgy, cgz = ctx.saved_tensors
        need_dx = ctx.needs_input_grad[0]
        need_dgrid = any(ctx.needs_input_grad[1:4])
        bwd = (warp_multi_pixel_bwd_cuda if _on_cuda("warp_multi_pixel", x)
               else warp_multi_pixel_bwd_plain)
        dx, dgrid = bwd(x, cgx, cgy, cgz, gout, ctx.spatial, need_dx, need_dgrid)
        dgrid = dgrid or (None, None, None)
        return (dx, *(d if need else None
                      for d, need in zip(dgrid, ctx.needs_input_grad[1:4])), None)


def _forward(x, cgx, cgy, cgz, spatial):
    fwd = warp_multi_pixel_cuda if _on_cuda("warp_multi_pixel", x) else warp_multi_pixel_plain
    # kept for a remat recompute, not launched again (remat.py)
    return remat.once(lambda: fwd(x, cgx, cgy, cgz, spatial))


def warp_multi_pixel(x, cgx, cgy, cgz, spatial):
    """Fused multi-grid warp with pixel-space coordinate planes; see the
    module docstring for layouts.  Differentiable in x and the coordinates."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, cgx, cgy, cgz)):
        return _WarpMultiPixel.apply(x, cgx, cgy, cgz, spatial)
    return _forward(x, cgx, cgy, cgz, spatial)


class _GridSample3d(torch.autograd.Function):
    """grid_sample_3d_fast with its backward: kernels on CUDA, plain
    versions on the CPU."""

    @staticmethod
    def forward(ctx, x, grid, gps):
        ctx.save_for_backward(x, grid)
        ctx.gps = gps
        return _grid_forward(x, grid, gps)

    @staticmethod
    def backward(ctx, gout):
        x, grid = ctx.saved_tensors
        need_dx, need_dgrid = ctx.needs_input_grad[:2]
        bwd = (grid_sample_3d_bwd_cuda if _on_cuda("grid_sample_3d_fast", x)
               else grid_sample_3d_bwd_plain)
        dx, dgrid = bwd(x, grid, gout, ctx.gps, need_dx, need_dgrid)
        return dx, dgrid, None


def _grid_forward(x, grid, gps):
    fwd = grid_sample_3d_cuda if _on_cuda("grid_sample_3d_fast", x) else grid_sample_3d_plain
    return remat.once(lambda: fwd(x, grid, gps))


def grid_sample_3d_fast(x, grid, grids_per_source: int = 1):
    """Trilinear grid_sample (align_corners=True, zeros padding) of x
    [N,D,H,W,C] at a normalized grid [N*gps,Do,Ho,Wo,3] -> [N*gps,Do,Ho,Wo,C]
    in x's dtype; grid g samples source g // gps.  Differentiable in x and
    the grid."""
    if torch.is_grad_enabled() and (x.requires_grad or grid.requires_grad):
        return _GridSample3d.apply(x, grid, grids_per_source)
    return _grid_forward(x, grid, grids_per_source)


def warp_single(x, deformation):
    """One-grid warp of x [N,D,H,W,C] by a normalized [-1,1] grid
    [N,Do,Ho,Wo,3] -> [N,Do,Ho,Wo,C].

    Dispatch, as the JAX package's on its chip (where its multi-grid plan
    exists only for bf16): bf16 goes through warp_multi_pixel at K1=1 on
    pixel coordinates; every other dtype through grid_sample_3d_fast
    directly on the normalized grid, with no pixel round trip."""
    if x.dtype != torch.bfloat16:
        return grid_sample_3d_fast(x, deformation, 1)
    return grid_sample_3d_multi(x, deformation[:, None], 1)


def grid_sample_3d_multi(x, grids, K1: int):
    """Warp ONE source volume x [N,D,H,W,C] by K1 normalized grids
    [N,K1,Do,Ho,Wo,3] into the fused k-major layout [N,Do,Ho,Wo,K1*C]
    (warp_multi_pixel on the grids' pixel coordinates)."""
    spatial = tuple(grids.shape[2:5])
    coords = _grid_pixels(x, grids.reshape(-1, *grids.shape[2:]), K1)
    return warp_multi_pixel(x, *coords, spatial)
