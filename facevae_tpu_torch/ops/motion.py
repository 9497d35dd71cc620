"""Dense motion from keypoint pairs, analytic forms only (port of
facevae_tpu/ops/motion.py:37-166), channel-last, in fp32.

Each candidate motion is affine in the voxel position,
motion_k(p) = jac (p - kp_d_k) + kp_s_k (identity for k=0), so the
[N,K+1,D,H,W,3] tensor never exists: the warp reads per-axis pixel coordinate
planes and the mask-blended deformation reduces to mask-weighted keypoint
tables.
"""
from __future__ import annotations

import torch

from facevae_tpu_torch.ops.geometry import make_coordinate_grid_3d
from facevae_tpu_torch.ops.heatmap import kp2gaussian_3d_cl


def create_heatmap_representations_cl(fs, kp_s, kp_d):
    """Difference-of-gaussian heatmaps [N,D,H,W,K+1], zero channel first.
    fs [N,D,H,W,C] gives only the spatial size."""
    spatial = fs.shape[1:4]
    heat = (kp2gaussian_3d_cl(kp_d.float(), spatial)
            - kp2gaussian_3d_cl(kp_s.float(), spatial))
    zeros = heat.new_zeros(heat.shape[:-1] + (1,))
    return torch.cat([zeros, heat], dim=-1)


def motion_affine_params(kp_s, kp_d, Rs, Rd):
    """jac [N,3,3] = Rs Rd^-1 and offsets b [N,K,3] = kp_s - jac kp_d."""
    kp_s, kp_d = kp_s.float(), kp_d.float()
    jac = torch.matmul(Rs.float(), torch.linalg.inv(Rd.float()))
    b = kp_s - torch.einsum("nij,nkj->nki", jac, kp_d)
    return jac, b


def sparse_motion_pixel_coords(spatial, jac, b, include_identity: bool = True):
    """Pixel-space coordinate planes (cgx, cgy, cgz), each [N,K(+1),NV].

    include_identity=False omits the k=0 identity row: that warp samples at
    exact integer coordinates, i.e. it is a copy of the source, which MFE
    concatenates directly."""
    D, H, W = spatial
    N, K, _ = b.shape
    NV = D * H * W
    grid = make_coordinate_grid_3d((D, H, W), device=b.device).reshape(NV, 3)
    q = torch.einsum("nij,vj->niv", jac, grid)                   # [N,3,NV]
    scale = ((W - 1) * 0.5, (H - 1) * 0.5, (D - 1) * 0.5)

    def axis(a):
        moved = (q[:, None, a, :] + (b[..., a] + 1.0)[..., None]) * scale[a]
        if not include_identity:
            return moved
        ident = (grid[:, a] + 1.0) * scale[a]                    # [NV]
        return torch.cat([ident[None, None].expand(N, 1, NV), moved], dim=1)

    return axis(0), axis(1), axis(2)


def blend_deformation(mask, jac, b):
    """deformation [N,D,H,W,3] = sum_k mask_k motion_k, for a softmaxed
    fp32 mask [N,D,H,W,K+1]."""
    N, D, H, W, K1 = mask.shape
    grid = make_coordinate_grid_3d((D, H, W), device=mask.device)
    jacp = torch.einsum("nij,dhwj->ndhwi", jac, grid)
    m0 = mask[..., 0:1]
    rest = mask[..., 1:]
    offsets = torch.einsum("ndhwk,nkc->ndhwc", rest, b)
    return m0 * grid[None] + rest.sum(-1, keepdim=True) * jacp + offsets
