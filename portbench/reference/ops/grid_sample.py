"""Bilinear / trilinear grid sampling with torch.nn.functional.grid_sample's
semantics, channel-last (port of facevae_tpu/ops/grid_sample.py).

The plain general-purpose op: corner gathers (torch.gather over the
flattened spatial axis) summed in the JAX function's order, accumulated in
fp32 and cast back to x's dtype.  The model's warps do not come here: they
go through ops/fast_warp.py and its kernels.  The TPS warp's fp32 branch
does (ops/tps.py).

  - align_corners=True:  ix = (gx + 1) / 2 * (W - 1)
  - align_corners=False: ix = ((gx + 1) * W - 1) / 2
  - padding_mode "zeros": out-of-bounds corners contribute 0
  - padding_mode "border": coordinates clamped to [0, size - 1]
  - padding_mode "reflection": coordinates reflected (about pixel centers
    with align_corners=True, about the edges otherwise), then clamped.

x [N,H,W,C] / [N,D,H,W,C]; grid [N,Ho,Wo,2] / [N,Do,Ho,Wo,3] in (x=W, y=H[,
z=D]) order, torch's grid convention.
"""
from __future__ import annotations

import torch

PADDING_MODES = ("zeros", "border", "reflection")


def _unnormalize(coord, size: int, align_corners: bool):
    if align_corners:
        return (coord + 1.0) * 0.5 * (size - 1)
    return ((coord + 1.0) * size - 1.0) * 0.5


def _reflect(coord, lo: float, hi: float):
    """Reflect coordinates into [lo, hi] (torch's reflect_coordinates); a
    span of 0 (size 1 with align_corners) is guarded."""
    span = max(hi - lo, 1e-12)
    coord = (coord - lo).abs()
    coord = torch.remainder(coord, 2.0 * span)
    coord = torch.where(coord > span, 2.0 * span - coord, coord)
    return coord + lo


def _apply_padding(coord, size: int, padding_mode: str, align_corners: bool):
    if padding_mode == "reflection":
        if align_corners:
            coord = _reflect(coord, 0.0, float(size - 1))
        else:
            coord = _reflect(coord, -0.5, size - 0.5)
        coord = torch.clamp(coord, 0.0, float(size - 1))
    elif padding_mode == "border":
        coord = torch.clamp(coord, 0.0, float(size - 1))
    elif padding_mode != "zeros":
        raise ValueError(f"padding_mode is one of {PADDING_MODES}, not {padding_mode!r}")
    return coord


def _sample(x, grid, align_corners: bool, padding_mode: str):
    """x [N,*S,C] at grid [N,*So,len(S)] (coordinates in x, y[, z] order)."""
    N, *spatial, C = x.shape
    out_spatial = grid.shape[1:-1]
    d = len(spatial)
    # pixel coordinates per spatial axis, outermost first (z, y, x)
    coords = [_apply_padding(_unnormalize(grid[..., d - 1 - a].float(), size, align_corners),
                             size, padding_mode, align_corners)
              for a, size in enumerate(spatial)]
    lows = [torch.floor(c) for c in coords]
    fracs = [c - lo for c, lo in zip(coords, lows)]
    flat = x.float().reshape(N, -1, C)
    out = torch.zeros((N, *out_spatial, C), dtype=torch.float32, device=x.device)
    for corner in range(2 ** d):
        # the JAX loops' order: z outermost, x innermost
        offs = [(corner >> (d - 1 - a)) & 1 for a in range(d)]
        w = None
        for a in reversed(range(d)):                      # weights in x, y, z order
            f = fracs[a] if offs[a] else 1.0 - fracs[a]
            w = f if w is None else w * f
        cs = [lo + o for lo, o in zip(lows, offs)]
        if padding_mode == "zeros":
            valid = None
            for a in reversed(range(d)):
                v = (cs[a] >= 0) & (cs[a] <= spatial[a] - 1)
                valid = v if valid is None else valid & v
            w = torch.where(valid, w, 0.0)
        idx = None
        for a in range(d):
            i = torch.clamp(cs[a], 0, spatial[a] - 1).long()
            idx = i if idx is None else idx * spatial[a] + i
        idx = idx.reshape(N, -1, 1).expand(-1, -1, C)
        vals = torch.gather(flat, 1, idx).reshape(N, *out_spatial, C)
        out = out + vals * w[..., None]
    return out.to(x.dtype)


def grid_sample_2d(x: torch.Tensor, grid: torch.Tensor, *, align_corners: bool = True,
                   padding_mode: str = "zeros") -> torch.Tensor:
    """x [N,H,W,C], grid [N,Ho,Wo,2] -> [N,Ho,Wo,C]."""
    return _sample(x, grid, align_corners, padding_mode)


def grid_sample_3d(x: torch.Tensor, grid: torch.Tensor, *, align_corners: bool = True,
                   padding_mode: str = "zeros") -> torch.Tensor:
    """x [N,D,H,W,C], grid [N,Do,Ho,Wo,3] (x, y, z order) -> [N,Do,Ho,Wo,C]."""
    return _sample(x, grid, align_corners, padding_mode)
