"""Random affine + thin-plate-spline warp of the equivariance constraint
(port of facevae_tpu/ops/tps.py, fp32 path).

The parameters are drawn from an explicit torch.Generator and carried in a
small NamedTuple, so a step can be replayed with injected parameters (the
tests hand both packages the same numpy draws).  The JAX package's bf16 MXU
branch of transform_frame is outside the fp32 port.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from facevae_tpu_torch.ops.geometry import make_coordinate_grid_2d


class TransformParams(NamedTuple):
    theta: torch.Tensor           # [N,2,3] affine (eye + noise)
    control_points: torch.Tensor  # [1,P*P,2]
    control_params: torch.Tensor  # [N,1,P*P]


def random_transform_params(generator: torch.Generator, bs: int, *,
                            sigma_affine: float = 0.05, sigma_tps: float = 0.005,
                            points_tps: int = 5, device=None) -> TransformParams:
    """theta = I + sigma_affine * normal, control params sigma_tps * normal
    (reference trainer.py:97-104), drawn from ``generator`` on ``device``."""
    eye = torch.eye(2, 3, device=device)[None]
    theta = eye + sigma_affine * torch.randn(bs, 2, 3, generator=generator, device=device)
    cp = make_coordinate_grid_2d((points_tps, points_tps), device=device).reshape(1, -1, 2)
    cparams = sigma_tps * torch.randn(bs, 1, points_tps * points_tps, generator=generator,
                                      device=device)
    return TransformParams(theta, cp, cparams)


def warp_coordinates(tp: TransformParams, coordinates: torch.Tensor) -> torch.Tensor:
    """coordinates [B,M,2] (B = N or 1) -> [N,M,2]: the affine map plus the
    TPS radial term r^2 log r on L1 distances to the control points."""
    theta = tp.theta[:, None]                                     # [N,1,2,3]
    transformed = torch.matmul(theta[..., :2], coordinates[..., None])[..., 0] + theta[..., 2]
    distances = (coordinates[:, :, None, :] - tp.control_points[:, None, :, :]).abs().sum(-1)
    radial = distances ** 2 * torch.log(distances + 1e-6)
    radial = (radial * tp.control_params).sum(dim=2)[..., None]   # [N,M,1]
    return transformed + radial


def _reflect(coord, lo: float, hi: float):
    """Reflect coordinates into [lo, hi] (torch's reflect_coordinates)."""
    span = max(hi - lo, 1e-12)
    coord = (coord - lo).abs()
    coord = torch.remainder(coord, 2.0 * span)
    coord = torch.where(coord > span, 2.0 * span - coord, coord)
    return coord + lo


def grid_sample_2d_reflect(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear grid_sample of x [N,H,W,C] at grid [N,Ho,Wo,2] in [-1,1],
    align_corners=True, reflection padding -> [N,Ho,Wo,C] fp32 (the JAX
    package's grid_sample_2d, written out so the two agree bit for bit)."""
    N, H, W, C = x.shape
    _, Ho, Wo, _ = grid.shape
    g = grid.float()
    gx = (g[..., 0] + 1.0) * 0.5 * (W - 1)
    gy = (g[..., 1] + 1.0) * 0.5 * (H - 1)
    gx = torch.clamp(_reflect(gx, 0.0, float(W - 1)), 0.0, float(W - 1))
    gy = torch.clamp(_reflect(gy, 0.0, float(H - 1)), 0.0, float(H - 1))
    x0, y0 = torch.floor(gx), torch.floor(gy)
    tx, ty = gx - x0, gy - y0
    flat = x.float().reshape(N, H * W, C)
    out = torch.zeros(N, Ho, Wo, C, dtype=torch.float32, device=x.device)
    for dy in (0, 1):
        for dx in (0, 1):
            w = (tx if dx else 1.0 - tx) * (ty if dy else 1.0 - ty)
            ix = torch.clamp(x0 + dx, 0, W - 1).long()
            iy = torch.clamp(y0 + dy, 0, H - 1).long()
            idx = (iy * W + ix).reshape(N, Ho * Wo, 1).expand(N, Ho * Wo, C)
            vals = torch.gather(flat, 1, idx).reshape(N, Ho, Wo, C)
            out = out + vals * w[..., None]
    return out


def transform_frame(tp: TransformParams, frame: torch.Tensor) -> torch.Tensor:
    """Warp frame [N,H,W,C] by the TPS-transformed sampling grid (reference
    trainer.py:106-110: grid_sample 2D, align_corners=True, reflection)."""
    N, H, W, C = frame.shape
    grid = make_coordinate_grid_2d((H, W), device=frame.device).reshape(1, H * W, 2)
    grid = warp_coordinates(tp, grid.to(tp.theta.dtype)).reshape(N, H, W, 2)
    return grid_sample_2d_reflect(frame.float(), grid)
