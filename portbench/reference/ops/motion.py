"""Dense motion from keypoint pairs (port of facevae_tpu/ops/motion.py), in
fp32.

Two forms compute the same warps.  The reference form (utils.py:139-179)
materializes the K+1 sparse motions [N,K+1,D,H,W,3] and warps the source by
each through grid_sample_3d_fast with grids_per_source = K+1.  The analytic
form, which MFE runs, uses that each candidate motion is affine in the voxel
position, motion_k(p) = jac (p - kp_d_k) + kp_s_k (identity for k=0): the
warp reads per-axis pixel coordinate planes and the mask-blended deformation
reduces to mask-weighted keypoint tables, channel-last.
"""
from __future__ import annotations

import torch

from portbench.reference.warp import grid_sample_3d_fast, grid_sample_3d_multi
from portbench.reference.ops.geometry import make_coordinate_grid_3d
from portbench.reference.ops.heatmap import kp2gaussian_3d, kp2gaussian_3d_cl


def create_heatmap_representations(fs, kp_s, kp_d):
    """Difference-of-gaussian heatmaps [N,K+1,D,H,W], zero channel first
    (the reference form; fs [N,D,H,W,C] gives only the spatial size)."""
    spatial = tuple(fs.shape[1:4])
    heat = kp2gaussian_3d(kp_d.float(), spatial) - kp2gaussian_3d(kp_s.float(), spatial)
    return torch.cat([heat.new_zeros((heat.shape[0], 1) + heat.shape[2:]), heat], dim=1)


def create_sparse_motions(fs, kp_s, kp_d, Rs, Rd):
    """The K+1 candidate backward warps [N,K+1,D,H,W,3], identity first:
    motion_k(p) = Rs Rd^-1 (p - kp_d_k) + kp_s_k, in fp32."""
    N, D, H, W = fs.shape[:4]
    kp_s, kp_d = kp_s.float(), kp_d.float()
    grid = make_coordinate_grid_3d((D, H, W), device=fs.device)       # [D,H,W,3]
    identity = grid[None, None].expand(N, 1, D, H, W, 3)
    coords = grid[None, None] - kp_d[:, :, None, None, None, :]        # [N,K,D,H,W,3]
    jac = torch.matmul(Rs.float(), torch.linalg.inv_ex(Rd.float())[0])
    moved = torch.einsum("nij,nkdhwj->nkdhwi", jac, coords) + kp_s[:, :, None, None, None, :]
    return torch.cat([identity, moved], dim=1)


def create_deformed_source_image(fs, sparse_motions):
    """fs [N,D,H,W,C] warped by each of the K+1 sparse motions
    [N,K+1,D,H,W,3] -> [N,K+1,D,H,W,C]: one grid_sample_3d_fast call whose
    K+1 grids per source share the un-repeated volume."""
    N, D, H, W, C = fs.shape
    K1 = sparse_motions.shape[1]
    warped = grid_sample_3d_fast(fs, sparse_motions.reshape(N * K1, D, H, W, 3), K1)
    return warped.reshape(N, K1, D, H, W, C)


def create_deformed_source_fused(fs, sparse_motions):
    """The same warps in MFE's fused k-major layout [N,D,H,W,(K+1)*C]
    (warp_multi_pixel)."""
    return grid_sample_3d_multi(fs, sparse_motions, sparse_motions.shape[1])


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
    jac = torch.matmul(Rs.float(), torch.linalg.inv_ex(Rd.float())[0])
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
