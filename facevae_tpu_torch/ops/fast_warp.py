"""Trilinear warp, forward only (port of facevae_tpu/ops/fast_warp.py:569-610).

Semantics: grid_sample 3D with align_corners=True and zeros padding, taking
per-axis PIXEL coordinate planes.  Layouts are the JAX package's:

  warp_multi_pixel(x [N,D,H,W,C], cgx/cgy/cgz [N,K1,NV], spatial)
      -> [N,Do,Ho,Wo,K1*C], k-major (channel k*C + c is grid k's sample of c)
  warp_single(x [N,D,H,W,C], deformation [N,Do,Ho,Wo,3] in [-1,1])
      -> [N,Do,Ho,Wo,C]

Dispatch is by the device of ``x`` alone: a CUDA tensor goes through the
hand-written kernel (csrc/warp_fwd.cu) or the call raises; a CPU tensor goes
through ``warp_multi_pixel_plain``, the kernel's plain PyTorch version.
The JAX package's z-banding, channel grouping and VMEM planners exist for
the TPU's memory and matrix unit and are not ported.

Each path counts its launches in ``launches`` (plain integers), so a run can
show which path the served graph took.
"""
from __future__ import annotations

import ctypes
import math

import torch

launches = {"warp_fwd": 0, "warp_fwd_plain": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535
_fn = None


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


def warp_multi_pixel_plain(x, cgx, cgy, cgz, spatial):
    """The kernel's plain version: an fp32 8-corner gather, result in x's
    dtype.  Same contract as ``warp_multi_pixel``."""
    _check(x, cgx, cgy, cgz, spatial)
    launches["warp_fwd_plain"] += 1
    N, D, H, W, C = x.shape
    K1, NV = cgx.shape[1], cgx.shape[2]
    src = x.float().reshape(N, D * H * W, C)
    g = [c.float().reshape(N, K1 * NV) for c in (cgx, cgy, cgz)]
    floors = [torch.floor(c) for c in g]
    fracs = [c - f for c, f in zip(g, floors)]
    out = torch.zeros(N, K1 * NV, C, dtype=torch.float32, device=x.device)
    sizes = (W, H, D)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                w = torch.ones_like(g[0])
                valid = torch.ones_like(g[0], dtype=torch.bool)
                idx = []
                for a, d in enumerate((dx, dy, dz)):
                    j = floors[a] + d
                    valid &= (j >= 0) & (j <= sizes[a] - 1)
                    w = w * (fracs[a] if d else 1.0 - fracs[a])
                    idx.append(j)
                # out-of-range (also NaN / inf) corners: weight 0, index 0
                w = torch.where(valid, w, 0.0)
                jx, jy, jz = (torch.where(valid, j, 0.0).long() for j in idx)
                flat = (jz * H + jy) * W + jx
                vals = torch.gather(src, 1, flat[..., None].expand(N, K1 * NV, C))
                out += w[..., None] * vals
    out = out.reshape(N, K1, NV, C).permute(0, 2, 1, 3)
    return out.reshape(N, *spatial, K1 * C).to(x.dtype)


def _kernel_fn():
    global _fn
    if _fn is None:
        from facevae_tpu_torch import kernels
        fn = kernels.load("warp_fwd").facevae_warp_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
        _fn = fn
    return _fn


def warp_multi_pixel_cuda(x, cgx, cgy, cgz, spatial):
    """Launch csrc/warp_fwd.cu on CUDA tensors; raises on anything the
    kernel does not take."""
    _check(x, cgx, cgy, cgz, spatial)
    if not x.is_cuda:
        raise ValueError(f"warp_fwd kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"warp_fwd kernel takes fp32 or bf16 x, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("warp_fwd kernel needs a contiguous channel-last x")
    for name, c in (("cgx", cgx), ("cgy", cgy), ("cgz", cgz)):
        if c.device != x.device or c.dtype != torch.float32 or not c.is_contiguous():
            raise ValueError(f"{name} must be a contiguous fp32 tensor on {x.device}, "
                             f"got {c.dtype} on {c.device}")
    N, D, H, W, C = x.shape
    K1, NV = cgx.shape[1], cgx.shape[2]
    if N * K1 > _MAX_GRID_Y:
        raise ValueError(f"N*K1={N * K1} exceeds the kernel's grid limit {_MAX_GRID_Y}")
    if NV >= 2 ** 31:
        raise ValueError(f"NV={NV} voxels exceeds the kernel's 32-bit voxel index")
    out = torch.empty((N, NV, K1 * C), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out.reshape(N, *spatial, K1 * C)
    item = x.element_size()
    cpt = 16 // item
    while cpt > 1 and (C % cpt or x.data_ptr() % (cpt * item)):
        cpt //= 2
    fn = _kernel_fn()
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), cgx.data_ptr(), cgy.data_ptr(), cgz.data_ptr(),
                 out.data_ptr(), N, D, H, W, C, K1, NV, _DTYPE_CODES[x.dtype], cpt,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"warp_fwd kernel launch failed with cudaError_t {err}")
    launches["warp_fwd"] += 1
    return out.reshape(N, *spatial, K1 * C)


def warp_multi_pixel(x, cgx, cgy, cgz, spatial):
    """Fused multi-grid warp with pixel-space coordinate planes; see the
    module docstring for layouts.  Forward only."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, cgx, cgy, cgz)):
        raise NotImplementedError(
            "warp_multi_pixel has no backward yet: the coordinate and source "
            "gradient kernels are ROADMAP Queue 2, kernels 2-3 "
            "(facevae_tpu/ops/pallas/warp_mm.py:_dgrid_multi_kernel, "
            "_drows_multi_kernel)")
    if x.device.type == "cuda":
        return warp_multi_pixel_cuda(x, cgx, cgy, cgz, spatial)
    if x.device.type == "cpu":
        return warp_multi_pixel_plain(x, cgx, cgy, cgz, spatial)
    raise ValueError(f"warp_multi_pixel runs on cuda or cpu, not {x.device}")


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
