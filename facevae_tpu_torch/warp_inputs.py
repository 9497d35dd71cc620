"""Coordinate sets the multi-grid warp kernels (csrc/warp_fwd.cu,
csrc/warp_bwd.cu) are checked and timed on: chip_smoke.py phase 3,
bench_warp.py and tests/test_torch_cuda.py draw them from here.

- ``noisy_coords``: an affine map of the grid per (n, k) plus N(0,1) noise
  per sample and axis, with ``with_probes``' values mixed in (the set phase
  3 has used since the first kernel);
- ``sparse_motion_coords``: MFE's own coordinates
  (``sparse_motion_pixel_coords``) from seeded keypoints and head poses,
  with or without the probes.

Every draw comes from the torch.Generator passed in, on its device, in a
fixed order, so two checkouts given the same seed get the same inputs.
"""
from __future__ import annotations

import torch

from facevae_tpu_torch.ops.geometry import pose_rotation
from facevae_tpu_torch.ops.motion import motion_affine_params, sparse_motion_pixel_coords


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
