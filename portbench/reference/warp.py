"""The warps as plain trilinear sampling: F.grid_sample (align_corners=True,
zeros padding) in fp32, with the layouts of the port's fast_warp calls so
the copied nets call them unchanged:

  warp_multi_pixel(x [N,D,H,W,C], cgx/cgy/cgz [N,K1,NV], spatial)
      -> [N,Do,Ho,Wo,K1*C], k-major; per-axis PIXEL coordinates
  grid_sample_3d_fast(x [N,D,H,W,C], grid [N*gps,Do,Ho,Wo,3], gps)
      -> [N*gps,Do,Ho,Wo,C]; a NORMALIZED [-1,1] grid, grid g samples
      source g // gps
  warp_single, grid_sample_3d_multi: the same on one or K1 normalized grids

Autograd differentiates them; no kernel of the program is used.  A pixel
coordinate c on an axis of size n becomes 2 c / (n - 1) - 1; an axis of
size 1 (the augmentation's depth) samples its one plane.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _normalized(c, size):
    if size == 1:
        return torch.zeros_like(c)
    return c * (2.0 / (size - 1)) - 1.0


def _sample(x, grid, gps):
    """x [N,D,H,W,C], grid [N*gps,Do,Ho,Wo,3] normalized -> [N*gps,C,Do,Ho,Wo]."""
    src = x.float().permute(0, 4, 1, 2, 3)
    if gps > 1:
        src = src.repeat_interleave(gps, dim=0)
    return F.grid_sample(src, grid.float(), mode="bilinear", padding_mode="zeros",
                         align_corners=True)


def warp_multi_pixel(x, cgx, cgy, cgz, spatial):
    N, D, H, W, C = x.shape
    K1 = cgx.shape[1]
    Do, Ho, Wo = spatial
    grid = torch.stack([_normalized(cgx.float(), W), _normalized(cgy.float(), H),
                        _normalized(cgz.float(), D)], dim=-1)
    out = _sample(x, grid.reshape(N * K1, Do, Ho, Wo, 3), K1)
    out = out.reshape(N, K1, C, Do, Ho, Wo).permute(0, 3, 4, 5, 1, 2)
    return out.reshape(N, Do, Ho, Wo, K1 * C).to(x.dtype)


def grid_sample_3d_fast(x, grid, grids_per_source: int = 1):
    return _sample(x, grid, grids_per_source).permute(0, 2, 3, 4, 1).to(x.dtype)


def warp_single(x, deformation):
    return grid_sample_3d_fast(x, deformation, 1)


def grid_sample_3d_multi(x, grids, K1: int):
    N, _, Do, Ho, Wo, _ = grids.shape
    C = x.shape[-1]
    out = _sample(x, grids.reshape(N * K1, Do, Ho, Wo, 3), K1)
    out = out.reshape(N, K1, C, Do, Ho, Wo).permute(0, 3, 4, 5, 1, 2)
    return out.reshape(N, Do, Ho, Wo, K1 * C).to(x.dtype)
