"""Random affine + thin-plate-spline warp of the equivariance constraint
(port of facevae_tpu/ops/tps.py).

The parameters are drawn from an explicit torch.Generator and carried in a
small NamedTuple, so a step can be replayed with injected parameters (the
tests hand both packages the same numpy draws).  transform_frame has the JAX
package's two branches: an exact fp32 gather, and at bf16 the warp kernel on
pre-reflected pixel coordinates.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.warp import warp_multi_pixel
from portbench.reference.ops.geometry import make_coordinate_grid_2d
from portbench.reference.ops.grid_sample import _apply_padding, _unnormalize, grid_sample_2d


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


def _reflected_pixels(g, size: int):
    """Normalized -> pixel coordinates, reflected into [0, size-1] and
    clipped: reflection padding becomes interior sampling."""
    return _apply_padding(_unnormalize(g, size, True), size, "reflection", True)


def transform_frame(tp: TransformParams, frame: torch.Tensor,
                    compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Warp frame [N,H,W,C] by the TPS-transformed sampling grid (reference
    trainer.py:106-110: grid_sample 2D, align_corners=True, reflection).

    fp32: grid_sample_2d's exact gather (as the JAX package's fp32
    branch), result fp32.  bf16: the JAX package's branch on its chip
    (facevae_tpu/ops/tps.py:71-83), on every device: the pixel
    coordinates are reflected and clipped up front, then the bf16 frame goes
    through warp_multi_pixel as a D=1 volume (the multi-grid warp kernel at
    K1=1, C=3; its plain version on the CPU); result bf16."""
    N, H, W, C = frame.shape
    grid = make_coordinate_grid_2d((H, W), device=frame.device).reshape(1, H * W, 2)
    grid = warp_coordinates(tp, grid.to(tp.theta.dtype)).reshape(N, H, W, 2)
    if compute_dtype == torch.bfloat16:
        gx = _reflected_pixels(grid[..., 0].float(), W).reshape(N, 1, H * W)
        gy = _reflected_pixels(grid[..., 1].float(), H).reshape(N, 1, H * W)
        out = warp_multi_pixel(frame.to(torch.bfloat16)[:, None], gx, gy,
                               torch.zeros_like(gx), (1, H, W))
        return out.reshape(N, H, W, C)
    if compute_dtype != torch.float32:
        raise ValueError(f"transform_frame computes in float32 or bfloat16, not {compute_dtype}")
    return grid_sample_2d(frame.float(), grid, align_corners=True, padding_mode="reflection")
