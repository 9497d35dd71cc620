"""Coordinate sets the warp kernels (multi-grid: csrc/warp_fwd.cu,
csrc/warp_bwd.cu; single-grid: csrc/warp_grid.cu) are checked and timed
on: chip_smoke.py phase 3, bench_warp.py and tests/test_torch_cuda.py draw
them from here.

- ``noisy_coords``: an affine map of the grid per (n, k) plus N(0,1) noise
  per sample and axis, with ``with_probes``' values mixed in (the set phase
  3 has used since the first kernel);
- ``sparse_motion_coords``: MFE's own coordinates
  (``sparse_motion_pixel_coords``) from seeded keypoints and head poses,
  with or without the probes;
- ``normalized``: pixel coordinate planes as the single-grid kernels' grid
  (the same samples);
- ``reference_form_grid``: the reference form's K+1 normalized grids per
  source (``create_sparse_motions``) with the probes.

Every draw comes from the torch.Generator passed in, on its device, in a
fixed order, so two checkouts given the same seed get the same inputs.
"""
from __future__ import annotations

import torch

from facevae_tpu_torch.ops.geometry import pose_rotation
from facevae_tpu_torch.ops.motion import (create_sparse_motions, motion_affine_params,
                                          sparse_motion_pixel_coords)


def with_probes(c, size, g):
    """Pixel coordinates c [3,...] with 10% exact integers, 0.5% the last
    index and 0.5% far-out, border and +-inf values mixed in."""
    dev = c.device
    pick = torch.rand(c.shape, generator=g, device=dev)
    c = torch.where(pick < 0.1, torch.round(c), c)                  # exact integers
    probes = torch.tensor([-1e30, -1e6, -1.0, -0.5, 0.0, 1e-3, 1e6, 1e30,
                           float("inf"), float("-inf")], device=dev)
    idx = torch.randint(0, probes.numel(), c.shape, generator=g, device=dev)
    c = torch.where(pick > 0.995, probes[idx], c)                   # far out / border
    c = torch.where((pick > 0.99) & (pick <= 0.995), size - 1, c)   # last index
    return [c[a].contiguous() for a in range(3)]


def noisy_coords(N, K1, D, H, W, g):
    """Pixel coordinates [3][N,K1,NV]: an affine map of the grid per (n, k)
    plus N(0,1) noise per sample and axis, reaching past the border, with
    with_probes' values mixed in."""
    dev = g.device
    z, y, x = torch.meshgrid(torch.arange(D, device=dev), torch.arange(H, device=dev),
                             torch.arange(W, device=dev), indexing="ij")
    base = torch.stack([x, y, z]).reshape(3, 1, 1, -1).float()       # [3,1,1,NV]
    size = torch.tensor([W, H, D], device=dev, dtype=torch.float32).reshape(3, 1, 1, 1)
    scale = 1 + 0.2 * (torch.rand(3, N, K1, 1, generator=g, device=dev) - 0.5)
    shift = 0.2 * size * (torch.rand(3, N, K1, 1, generator=g, device=dev) - 0.5)
    noise = torch.randn(3, N, K1, base.shape[-1], generator=g, device=dev)
    c = (base - size / 2) * scale + size / 2 + shift + noise
    return with_probes(c, size, g)


def sparse_motion_coords(N, K, D, H, W, g, probes=False):
    """MFE's pixel coordinates [3][N,K,NV] (sparse_motion_pixel_coords
    without the identity grid, as models/mfe.py calls it) from keypoints
    U(-0.6, 0.6) and head poses (yaw, pitch, roll) U(-0.5, 0.5) rad of source
    and driving, drawn as chip_smoke.py's reference-form grids are; with
    ``probes``, with_probes' values mixed in as there."""
    dev = g.device
    kp_s, kp_d = (torch.rand(N, K, 3, generator=g, device=dev) * 1.2 - 0.6 for _ in range(2))
    Rs, Rd = (pose_rotation(*(torch.rand(N, generator=g, device=dev) - 0.5 for _ in range(3)))
              for _ in range(2))
    jac, b = motion_affine_params(kp_s, kp_d, Rs, Rd)
    c = torch.stack(sparse_motion_pixel_coords((D, H, W), jac, b, include_identity=False))
    if not probes:
        return [c[a].contiguous() for a in range(3)]
    size = torch.tensor([W, H, D], device=dev, dtype=torch.float32).reshape(3, 1, 1, 1)
    return with_probes(c, size, g)


def normalized(coords, D, H, W):
    """Pixel coordinate planes [3][N,K1,NV] -> the normalized grid
    [N*K1,D,H,W,3] that samples the same points (on an axis of size 1 every
    normalized value samples pixel 0: 0 there)."""
    N, K1 = coords[0].shape[:2]
    grid = torch.stack([c * (2.0 / (s - 1)) - 1.0 if s > 1 else torch.zeros_like(c)
                        for c, s in zip(coords, (W, H, D))], -1)
    return grid.reshape(N * K1, D, H, W, 3).contiguous()


def reference_form_grid(N, K, D, H, W, g):
    """The reference form's K+1 grids per source [N*(K+1),D,H,W,3]:
    create_sparse_motions on keypoints and head poses drawn as in
    sparse_motion_coords, with with_probes' values mixed in (in pixel
    units)."""
    dev = g.device
    kp_s, kp_d = (torch.rand(N, K, 3, generator=g, device=dev) * 1.2 - 0.6 for _ in range(2))
    Rs, Rd = (pose_rotation(*(torch.rand(N, generator=g, device=dev) - 0.5 for _ in range(3)))
              for _ in range(2))
    fs = torch.empty(N, D, H, W, 1, device=dev)                        # shape only
    motions = create_sparse_motions(fs, kp_s, kp_d, Rs, Rd).reshape(-1, 3)
    size = torch.tensor([W, H, D], device=dev, dtype=torch.float32).reshape(3, 1)
    px = (motions.t() + 1.0) * 0.5 * (size - 1)
    return normalized([c.reshape(N, K + 1, -1) for c in with_probes(px, size, g)], D, H, W)
