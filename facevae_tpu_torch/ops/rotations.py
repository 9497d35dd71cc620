"""Rotation representations (port of facevae_tpu/ops/rotations.py, the
reference's models_utils.py:837-930): Rodrigues, quaternion and axis-angle
conversions and geodesic interpolation.  Computed in the input's dtype
(float64 stays float64), with the JAX functions' eps guards, arccos clip and
the quaternion's w >= 0 convention."""
from __future__ import annotations

import torch


def rodrigues(rvec: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Axis-angle vectors [N,3] -> rotation matrices [N,3,3]."""
    theta = torch.linalg.vector_norm(rvec, dim=-1, keepdim=True)      # [N,1]
    axis = rvec / torch.clamp_min(theta, eps)
    x, y, z = axis[:, 0], axis[:, 1], axis[:, 2]
    zero = torch.zeros_like(x)
    K = torch.stack([zero, -z, y,
                     z, zero, -x,
                     -y, x, zero], dim=-1).reshape(-1, 3, 3)
    t = theta[..., None]
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    return eye + torch.sin(t) * K + (1.0 - torch.cos(t)) * (K @ K)


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternions [N,4] (w, x, y, z), normalized here -> [N,3,3]."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(-1, 3, 3)


def matrix_to_quaternion(R: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """[N,3,3] -> unit quaternions [N,4] (w, x, y, z), w >= 0."""
    m00, m11, m22 = R[:, 0, 0], R[:, 1, 1], R[:, 2, 2]
    w = torch.sqrt(torch.clamp_min(1.0 + m00 + m11 + m22, eps)) / 2.0
    w4 = torch.clamp_min(4.0 * w, eps)
    x = (R[:, 2, 1] - R[:, 1, 2]) / w4
    y = (R[:, 0, 2] - R[:, 2, 0]) / w4
    z = (R[:, 1, 0] - R[:, 0, 1]) / w4
    q = torch.stack([w, x, y, z], dim=-1)
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def matrix_to_axisangle(R: torch.Tensor, eps: float = 1e-8):
    """[N,3,3] -> (axis [N,3], angle [N])."""
    angle = torch.arccos(torch.clamp((R[:, 0, 0] + R[:, 1, 1] + R[:, 2, 2] - 1.0) / 2.0,
                                     -1.0, 1.0))
    vec = torch.stack([R[:, 2, 1] - R[:, 1, 2],
                       R[:, 0, 2] - R[:, 2, 0],
                       R[:, 1, 0] - R[:, 0, 1]], dim=-1)
    axis = vec / torch.clamp_min(torch.linalg.vector_norm(vec, dim=-1, keepdim=True), eps)
    return axis, angle


def axisangle_to_matrix(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """(axis [N,3], angle [N]) -> [N,3,3]."""
    return rodrigues(axis * angle[:, None])


def rotation_interp(R0: torch.Tensor, R1: torch.Tensor, alpha) -> torch.Tensor:
    """Geodesic interpolation from R0 (alpha 0) to R1 (alpha 1) through the
    relative rotation's axis-angle."""
    rel = torch.matmul(R1, R0.transpose(-1, -2))
    axis, angle = matrix_to_axisangle(rel)
    return torch.matmul(axisangle_to_matrix(axis, angle * alpha), R0)
