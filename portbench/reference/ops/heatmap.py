"""Heatmap <-> keypoint conversions (port of facevae_tpu/ops/heatmap.py).

The channel-last forms (``*_cl``, the models' own) compute in fp32 whatever
the input dtype: heatmap mass and soft-argmax coordinates are
precision-critical.  The channel-first forms (out2heatmap, heatmap2kp,
kp2gaussian_2d / _3d, the reference's utils.py:106-136) compute in the
input's dtype, as the JAX functions do."""
from __future__ import annotations

import torch

from portbench.reference.ops.geometry import make_coordinate_grid_2d, make_coordinate_grid_3d


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


def kp2gaussian_3d(kp: torch.Tensor, spatial_size, kp_variance: float = 0.01) -> torch.Tensor:
    """Gaussian bumps at keypoints, keypoint-major: kp [N,K,3] -> [N,K,D,H,W]
    (the reference form, utils.py:130-136)."""
    grid = make_coordinate_grid_3d(spatial_size, dtype=kp.dtype, device=kp.device)
    diff = grid[None, None] - kp[:, :, None, None, None, :]
    return torch.exp(-0.5 * torch.sum(diff * diff, dim=-1) / kp_variance)


def kp2gaussian_2d_cl(kp: torch.Tensor, spatial_size,
                      kp_variance: float = 0.01) -> torch.Tensor:
    """Gaussian bumps at keypoints: kp [N,K,2] -> [N,H,W,K]."""
    grid = make_coordinate_grid_2d(spatial_size, dtype=kp.dtype, device=kp.device)
    diff = grid[None, :, :, None, :] - kp[:, None, None, :, :]
    return torch.exp(-0.5 * torch.sum(diff * diff, dim=-1) / kp_variance)


def out2heatmap(out: torch.Tensor, temperature: float = 0.1) -> torch.Tensor:
    """out [N,K,*spatial] -> softmax(out / T) over the spatial positions per
    (n, k), in out's dtype: T rounded to it (JAX's weak-typed scalar), then
    jax.nn.softmax's steps, each rounded to it."""
    shape = out.shape
    temperature = torch.tensor(temperature, dtype=out.dtype).item()
    flat = out.reshape(shape[0], shape[1], -1) / temperature
    e = torch.exp(flat - flat.amax(dim=2, keepdim=True).detach())
    return (e / e.sum(dim=2, keepdim=True)).reshape(shape)


def heatmap2kp(heatmap: torch.Tensor) -> torch.Tensor:
    """Soft-argmax: [N,K,D,H,W] -> expected grid coordinate [N,K,3] (x, y,
    z), the grid in the heatmap's dtype."""
    grid = make_coordinate_grid_3d(heatmap.shape[2:], dtype=heatmap.dtype,
                                   device=heatmap.device)
    return torch.einsum("nkdhw,dhwc->nkc", heatmap, grid)


def kp2gaussian_2d(kp: torch.Tensor, spatial_size, kp_variance: float = 0.01) -> torch.Tensor:
    """Gaussian bumps at keypoints, keypoint-major: kp [N,K,2] -> [N,K,H,W]."""
    grid = make_coordinate_grid_2d(spatial_size, dtype=kp.dtype, device=kp.device)
    diff = grid[None, None] - kp[:, :, None, None, :]
    return torch.exp(-0.5 * torch.sum(diff * diff, dim=-1) / kp_variance)
