"""Keypoint-space and pose losses (port of facevae_tpu/losses/keypoint.py)."""
from __future__ import annotations

import math

import torch


def equivariance_loss(kp_d: torch.Tensor, reverse_kp: torch.Tensor) -> torch.Tensor:
    """L1 between the driving keypoints' (x, y) and the TPS-inverse-warped ones."""
    return torch.mean(torch.abs(kp_d[:, :, :2] - reverse_kp))


def keypoint_prior_loss(kp_d: torch.Tensor, Dt: float = 0.1, zt: float = 0.33) -> torch.Tensor:
    """Hinge on squared pairwise distances plus the mean-depth anchor."""
    diff = kp_d[:, :, None, :] - kp_d[:, None, :, :]
    dist_sq = torch.sum(diff * diff, dim=-1)                       # [N,K,K]
    hinge = torch.clamp(Dt - dist_sq, min=0.0).sum(dim=(1, 2)).mean()
    depth = torch.abs(kp_d[:, :, 2].mean(dim=1) - zt).mean()
    return hinge + depth - kp_d.shape[1] * Dt


def headpose_loss(yaw, pitch, roll, real_yaw, real_pitch, real_roll) -> torch.Tensor:
    """L1 against the frozen Hopenet's angles (detached), /3, in degrees."""
    loss = (torch.mean(torch.abs(yaw - real_yaw.detach()))
            + torch.mean(torch.abs(pitch - real_pitch.detach()))
            + torch.mean(torch.abs(roll - real_roll.detach()))) / 3.0
    return loss / math.pi * 180.0


def deformation_prior_loss(delta_d: torch.Tensor) -> torch.Tensor:
    """mean |delta|; the step feeds kp_d_old - kp_d (quirk q11)."""
    return torch.mean(torch.abs(delta_d))
