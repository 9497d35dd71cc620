"""Keypoint geometry: rotation matrices, pose transforms, coordinate grids.

Port of facevae_tpu/ops/geometry.py.  Coordinates are ordered (x=W, y=H, z=D)
and normalized to [-1, 1] (grid_sample's layout, align_corners=True spacing).
"""
from __future__ import annotations

import torch

from portbench.reference.numerics import constant


def _rows(entries):
    return torch.stack(entries, dim=-1).reshape(-1, 3, 3)


def rotation_matrix_x(theta: torch.Tensor) -> torch.Tensor:
    """[N] -> [N,3,3]: [[c,0,s],[0,1,0],[-s,0,c]]."""
    theta = theta.reshape(-1)
    c, s = torch.cos(theta), torch.sin(theta)
    z, o = torch.zeros_like(theta), torch.ones_like(theta)
    return _rows([c, z, s, z, o, z, -s, z, c])


def rotation_matrix_y(theta: torch.Tensor) -> torch.Tensor:
    """[N] -> [N,3,3]: [[1,0,0],[0,c,-s],[0,s,c]]."""
    theta = theta.reshape(-1)
    c, s = torch.cos(theta), torch.sin(theta)
    z, o = torch.zeros_like(theta), torch.ones_like(theta)
    return _rows([o, z, z, z, c, -s, z, s, c])


def rotation_matrix_z(theta: torch.Tensor) -> torch.Tensor:
    """[N] -> [N,3,3]: [[c,-s,0],[s,c,0],[0,0,1]]."""
    theta = theta.reshape(-1)
    c, s = torch.cos(theta), torch.sin(theta)
    z, o = torch.zeros_like(theta), torch.ones_like(theta)
    return _rows([c, -s, z, s, c, z, z, z, o])


def pose_rotation(yaw, pitch, roll) -> torch.Tensor:
    """R = Ry(pitch) @ Rx(yaw) @ Rz(roll)."""
    return rotation_matrix_y(pitch) @ rotation_matrix_x(yaw) @ rotation_matrix_z(roll)


def transform_kp(canonical_kp, yaw, pitch, roll, t, scale):
    """kp = R @ (scale * kp_c) + t.

    canonical_kp [N,K,3]; yaw/pitch/roll [N]; t [N,3]; scale [N,1,1,1].
    Returns (kp [N,K,3], R [N,3,3])."""
    rot_mat = pose_rotation(yaw, pitch, roll)
    scaled = scale * canonical_kp[..., None]                 # [N,K,3,1]
    kp = torch.matmul(rot_mat[:, None], scaled)[..., 0]      # [N,K,3]
    return kp + t[:, None, :], rot_mat


def transform_kp_with_new_pose(canonical_kp, yaw, pitch, roll, t, delta,
                               new_yaw, new_pitch, new_roll):
    """kp' = R_new kp_c + t + (R_new R_old^-1) delta, then z shifted so the
    mean depth (over the whole batch, as in the reference) is 0.33."""
    old_rot = pose_rotation(yaw, pitch, roll)
    rot_mat = pose_rotation(new_yaw, new_pitch, new_roll)
    rel = torch.matmul(rot_mat, torch.linalg.inv_ex(old_rot)[0])   # _ex: no host sync
    kp = (torch.matmul(rot_mat[:, None], canonical_kp[..., None])[..., 0]
          + t[:, None, :]
          + torch.matmul(rel[:, None], delta[..., None])[..., 0])
    zt = 0.33 - kp[:, :, 2].mean()
    unit_z = constant((0.0, 0.0, 1.0), kp.dtype, kp.device)
    return kp + unit_z * zt, rot_mat


def _axis(n, dtype, device):
    return 2.0 * (torch.arange(n, dtype=dtype, device=device) / (n - 1)) - 1.0


def make_coordinate_grid_2d(spatial_size, dtype=torch.float32, device=None):
    """[H,W,2] grid, channel order (x=W, y=H), each in [-1,1]."""
    h, w = spatial_size
    y, x = _axis(h, dtype, device), _axis(w, dtype, device)
    return torch.stack([x[None, :].expand(h, w), y[:, None].expand(h, w)], dim=-1)


def make_coordinate_grid_3d(spatial_size, dtype=torch.float32, device=None):
    """[D,H,W,3] grid, channel order (x=W, y=H, z=D), each in [-1,1]."""
    d, h, w = spatial_size
    z = _axis(d, dtype, device)
    y = _axis(h, dtype, device)
    x = _axis(w, dtype, device)
    return torch.stack([x[None, None, :].expand(d, h, w),
                        y[None, :, None].expand(d, h, w),
                        z[:, None, None].expand(d, h, w)], dim=-1)
