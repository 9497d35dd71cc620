"""Trilinear warp and its gradient (port of facevae_tpu/ops/fast_warp.py:569-610).

Semantics: grid_sample 3D with align_corners=True and zeros padding, taking
per-axis PIXEL coordinate planes.  Layouts are the JAX package's:

  warp_multi_pixel(x [N,D,H,W,C], cgx/cgy/cgz [N,K1,NV], spatial)
      -> [N,Do,Ho,Wo,K1*C], k-major (channel k*C + c is grid k's sample of c)
  warp_single(x [N,D,H,W,C], deformation [N,Do,Ho,Wo,3] in [-1,1])
      -> [N,Do,Ho,Wo,C]

warp_multi_pixel is differentiable (a torch.autograd.Function): its
backward returns dx in x's dtype and dgx/dgy/dgz in pixel units; autograd
carries warp_single's (size-1)/2 chain rule back to the normalized grid.

Dispatch is by the device of ``x`` alone: a CUDA tensor goes through the
hand-written kernels or the call raises; a CPU tensor goes through their
plain PyTorch versions.

  forward          csrc/warp_fwd.cu            warp_multi_pixel_plain
  d coordinates    csrc/warp_bwd.cu (dgrid)    warp_multi_pixel_bwd_plain
  d source         csrc/warp_bwd.cu (dx)       warp_multi_pixel_bwd_plain

The backward skips the half that autograd does not need.  Its dx kernel adds
with atomics, so the last bits of dx vary from run to run: with
torch.use_deterministic_algorithms(True) a CUDA backward that needs dx
raises, as PyTorch's own grid_sample backward does.  The JAX package's
z-banding, channel grouping and VMEM planners exist for the TPU's memory and
matrix unit and are not ported.

Each path counts its launches in ``launches`` (plain integers), so a run can
show which path the served or trained graph took.
"""
from __future__ import annotations

import ctypes
import math

import torch

launches = {"warp_fwd": 0, "warp_fwd_plain": 0,
            "warp_bwd_dgrid": 0, "warp_bwd_dgrid_plain": 0,
            "warp_bwd_dx": 0, "warp_bwd_dx_plain": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535
_fns = {}


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


def warp_multi_pixel_plain(x, cgx, cgy, cgz, spatial):
    """The forward kernel's plain version: an fp32 8-corner gather, result in
    x's dtype.  Same contract as ``warp_multi_pixel``."""
    _check(x, cgx, cgy, cgz, spatial)
    launches["warp_fwd_plain"] += 1
    N, D, H, W, C = x.shape
    K1, NV = cgx.shape[1], cgx.shape[2]
    src = x.to(_acc_dtype(x)).reshape(N, D * H * W, C)
    out = torch.zeros(N, K1 * NV, C, dtype=src.dtype, device=x.device)
    for flat, w, _ in _corners(x, cgx, cgy, cgz):
        vals = torch.gather(src, 1, flat[..., None].expand(N, K1 * NV, C))
        out += w[..., None] * vals
    out = out.reshape(N, K1, NV, C).permute(0, 2, 1, 3)
    return out.reshape(N, *spatial, K1 * C).to(x.dtype)


def _gout_k_major(gout, dtype, N, K1, NV, C):
    """gout [N, *spatial, K1*C] -> [N, K1*NV, C], rows in (k, v) order."""
    return gout.to(dtype).reshape(N, NV, K1, C).permute(0, 2, 1, 3).reshape(N, K1 * NV, C)


def warp_multi_pixel_bwd_plain(x, cgx, cgy, cgz, gout, spatial, need_dx=True,
                               need_dgrid=True):
    """The backward kernels' plain version.  gout [N,*spatial,K1*C] is the
    cotangent of the forward's output.  Returns (dx in x's dtype or None,
    (dgx, dgy, dgz) [N,K1,NV] in pixel units, in the coordinates' dtype, or
    None); sums in fp32."""
    _check(x, cgx, cgy, cgz, spatial)
    N, D, H, W, C = x.shape
    K1, NV = cgx.shape[1], cgx.shape[2]
    acc = _acc_dtype(x)
    g = _gout_k_major(gout, acc, N, K1, NV, C)
    src = x.to(acc).reshape(N, D * H * W, C)
    dsrc = torch.zeros_like(src) if need_dx else None
    dg = [torch.zeros(N, K1 * NV, dtype=acc, device=x.device)
          for _ in range(3)] if need_dgrid else None
    for flat, w, dw in _corners(x, cgx, cgy, cgz):
        index = flat[..., None].expand(N, K1 * NV, C)
        if need_dgrid:
            dot = (torch.gather(src, 1, index) * g).sum(-1)
            for a in range(3):
                dg[a] += dw[a] * dot
        if need_dx:
            dsrc.scatter_add_(1, index, w[..., None] * g)
    dx = dgrid = None
    if need_dx:
        launches["warp_bwd_dx_plain"] += 1
        dx = dsrc.reshape(x.shape).to(x.dtype)
    if need_dgrid:
        launches["warp_bwd_dgrid_plain"] += 1
        dgrid = tuple(d.reshape(N, K1, NV).to(cgx.dtype) for d in dg)
    return dx, dgrid


_SIGNATURES = {
    # name: (library, C symbol, argtypes)
    "warp_fwd": ("warp_fwd", "facevae_warp_fwd",
                 [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]),
    "warp_bwd_dgrid": ("warp_bwd", "facevae_warp_bwd_dgrid",
                       [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p]),
    "warp_bwd_dx": ("warp_bwd", "facevae_warp_bwd_dx",
                    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]),
}


def _kernel_fn(name):
    if name not in _fns:
        from facevae_tpu_torch import kernels
        lib, symbol, argtypes = _SIGNATURES[name]
        fn = getattr(kernels.load(lib), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _fns[name] = fn
    return _fns[name]


def _check_cuda(name, x, cgx, cgy, cgz, spatial):
    """The checks every kernel wrapper makes before it launches."""
    _check(x, cgx, cgy, cgz, spatial)
    if not x.is_cuda:
        raise ValueError(f"{name} kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} kernel takes fp32 or bf16 x, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} kernel needs a contiguous channel-last x")
    for cname, c in (("cgx", cgx), ("cgy", cgy), ("cgz", cgz)):
        if c.device != x.device or c.dtype != torch.float32 or not c.is_contiguous():
            raise ValueError(f"{cname} must be a contiguous fp32 tensor on {x.device}, "
                             f"got {c.dtype} on {c.device}")
    N, K1, NV = cgx.shape
    if N * K1 > _MAX_GRID_Y:
        raise ValueError(f"N*K1={N * K1} exceeds the kernel's grid limit {_MAX_GRID_Y}")
    if NV >= 2 ** 31:
        raise ValueError(f"NV={NV} voxels exceeds the kernel's 32-bit voxel index")


def _cpt(C, item, *tensors):
    """Channels per 16-byte vector that C and every pointer's alignment allow."""
    cpt = 16 // item
    while cpt > 1 and (C % cpt or any(t.data_ptr() % (cpt * item) for t in tensors)):
        cpt //= 2
    return cpt


def _launch(name, *args):
    err = _kernel_fn(name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with cudaError_t {err}")
    launches[name] += 1


def warp_multi_pixel_cuda(x, cgx, cgy, cgz, spatial):
    """Launch csrc/warp_fwd.cu on CUDA tensors; raises on anything the
    kernel does not take."""
    _check_cuda("warp_fwd", x, cgx, cgy, cgz, spatial)
    N, D, H, W, C = x.shape
    K1, NV = cgx.shape[1], cgx.shape[2]
    out = torch.empty((N, NV, K1 * C), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out.reshape(N, *spatial, K1 * C)
    cpt = _cpt(C, x.element_size(), x)
    with torch.cuda.device(x.device):
        _launch("warp_fwd", x.data_ptr(), cgx.data_ptr(), cgy.data_ptr(), cgz.data_ptr(),
                out.data_ptr(), N, D, H, W, C, K1, NV, _DTYPE_CODES[x.dtype], cpt,
                torch.cuda.current_stream(x.device).cuda_stream)
    return out.reshape(N, *spatial, K1 * C)


def warp_multi_pixel_bwd_cuda(x, cgx, cgy, cgz, gout, spatial, need_dx=True,
                              need_dgrid=True):
    """Launch csrc/warp_bwd.cu's kernels on CUDA tensors (the dgrid kernel
    if need_dgrid, the dx kernel if need_dx); same contract as
    ``warp_multi_pixel_bwd_plain``.  gout is read in x's dtype; dx is summed
    in an fp32 buffer and cast once.  Raises on anything the kernels do not
    take, and on a dx request in deterministic mode (its atomics are not)."""
    _check_cuda("warp_bwd", x, cgx, cgy, cgz, spatial)
    N, D, H, W, C = x.shape
    K1, NV = cgx.shape[1], cgx.shape[2]
    if gout.shape != (N, *spatial, K1 * C):
        raise ValueError(f"gout must be {(N, *spatial, K1 * C)}, got {tuple(gout.shape)}")
    if gout.device != x.device:
        raise ValueError(f"gout lies on {gout.device}, x on {x.device}")
    if need_dx and torch.are_deterministic_algorithms_enabled():
        raise RuntimeError(
            "warp_multi_pixel's CUDA backward has no deterministic implementation: its dx "
            "kernel sums with atomics (ROADMAP Queue 2 holds the deterministic mode)")
    gout = gout.to(x.dtype).contiguous()
    dtype, stream = _DTYPE_CODES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream
    dx = dgrid = None
    with torch.cuda.device(x.device):
        if need_dgrid:
            dgrid = tuple(torch.empty_like(cgx) for _ in range(3))
            if cgx.numel():
                cpt = _cpt(C, x.element_size(), x, gout)
                _launch("warp_bwd_dgrid", x.data_ptr(), cgx.data_ptr(), cgy.data_ptr(),
                        cgz.data_ptr(), gout.data_ptr(), *(d.data_ptr() for d in dgrid),
                        N, D, H, W, C, K1, NV, dtype, cpt, stream)
        if need_dx:
            acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
            if cgx.numel():
                cpt = _cpt(C, x.element_size(), gout, acc)
                _launch("warp_bwd_dx", cgx.data_ptr(), cgy.data_ptr(), cgz.data_ptr(),
                        gout.data_ptr(), acc.data_ptr(), N, D, H, W, C, K1, NV, dtype, cpt,
                        stream)
            dx = acc.to(x.dtype)
    return dx, dgrid


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
        bwd = (warp_multi_pixel_bwd_cuda if x.device.type == "cuda"
               else warp_multi_pixel_bwd_plain)
        dx, dgrid = bwd(x, cgx, cgy, cgz, gout, ctx.spatial, need_dx, need_dgrid)
        dgrid = dgrid or (None, None, None)
        return (dx, *(d if need else None
                      for d, need in zip(dgrid, ctx.needs_input_grad[1:4])), None)


def _forward(x, cgx, cgy, cgz, spatial):
    if x.device.type == "cuda":
        return warp_multi_pixel_cuda(x, cgx, cgy, cgz, spatial)
    if x.device.type == "cpu":
        return warp_multi_pixel_plain(x, cgx, cgy, cgz, spatial)
    raise ValueError(f"warp_multi_pixel runs on cuda or cpu, not {x.device}")


def warp_multi_pixel(x, cgx, cgy, cgz, spatial):
    """Fused multi-grid warp with pixel-space coordinate planes; see the
    module docstring for layouts.  Differentiable in x and the coordinates."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, cgx, cgy, cgz)):
        return _WarpMultiPixel.apply(x, cgx, cgy, cgz, spatial)
    return _forward(x, cgx, cgy, cgz, spatial)


def warp_single(x, deformation):
    """One-grid warp of x [N,D,H,W,C] by a normalized [-1,1] grid
    [N,Do,Ho,Wo,3] -> [N,Do,Ho,Wo,C] (warp_multi_pixel at K1=1)."""
    N, D, H, W, C = x.shape
    spatial = tuple(deformation.shape[1:4])
    d = deformation.float().reshape(N, 1, math.prod(spatial), 3)
    return warp_multi_pixel(x,
                            (d[..., 0] + 1.0) * ((W - 1) * 0.5),
                            (d[..., 1] + 1.0) * ((H - 1) * 0.5),
                            (d[..., 2] + 1.0) * ((D - 1) * 0.5),
                            spatial)
