"""Heatmap <-> keypoint conversions, channel-last (port of
facevae_tpu/ops/heatmap.py).  Computed in fp32 whatever the input dtype:
heatmap mass and soft-argmax coordinates are precision-critical."""
from __future__ import annotations

import torch

from facevae_tpu_torch.ops.geometry import make_coordinate_grid_2d, make_coordinate_grid_3d


def out2heatmap_cl(out: torch.Tensor, temperature: float = 0.1) -> torch.Tensor:
    """out [N,D,H,W,K] -> softmax(out / T) over (D,H,W) per (n, k)."""
    shape = out.shape
    flat = out.reshape(shape[0], -1, shape[-1]).float()
    return torch.softmax(flat / temperature, dim=1).reshape(shape)


def heatmap2kp_cl(heatmap: torch.Tensor) -> torch.Tensor:
    """Soft-argmax: [N,D,H,W,K] -> expected grid coordinate [N,K,3]."""
    heatmap = heatmap.float()
    grid = make_coordinate_grid_3d(heatmap.shape[1:4], device=heatmap.device)
    return torch.einsum("ndhwk,dhwc->nkc", heatmap, grid)


def kp2gaussian_3d_cl(kp: torch.Tensor, spatial_size,
                      kp_variance: float = 0.01) -> torch.Tensor:
    """Gaussian bumps at keypoints: kp [N,K,3] -> [N,D,H,W,K]."""
    grid = make_coordinate_grid_3d(spatial_size, dtype=kp.dtype, device=kp.device)
    diff = grid[None, :, :, :, None, :] - kp[:, None, None, None, :, :]
    return torch.exp(-0.5 * torch.sum(diff * diff, dim=-1) / kp_variance)


def kp2gaussian_2d_cl(kp: torch.Tensor, spatial_size,
                      kp_variance: float = 0.01) -> torch.Tensor:
    """Gaussian bumps at keypoints: kp [N,K,2] -> [N,H,W,K]."""
    grid = make_coordinate_grid_2d(spatial_size, dtype=kp.dtype, device=kp.device)
    diff = grid[None, :, :, None, :] - kp[:, None, None, :, :]
    return torch.exp(-0.5 * torch.sum(diff * diff, dim=-1) / kp_variance)
