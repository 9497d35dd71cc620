"""Resize / pooling primitives with torch semantics (port of
facevae_tpu/ops/interpolate.py).

The JAX package builds these from matmuls and reshapes to match torch's
F.interpolate / pooling exactly; here they ARE torch's ops.  Layouts are
PyTorch's own, [N,C,H,W] / [N,C,D,H,W] — the blocks that use them run NC(D)HW.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def interpolate_bilinear_2d(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear resize [N,C,H,W] -> [N,C,Ho,Wo], align_corners=False, no
    antialiasing (the reference's F.interpolate); summed in fp32 at least
    and returned in x's dtype, as the JAX package does."""
    if tuple(out_hw) == tuple(x.shape[-2:]):
        return x
    y = F.interpolate(x.to(torch.promote_types(x.dtype, torch.float32)), size=tuple(out_hw),
                      mode="bilinear", align_corners=False, antialias=False)
    return y.to(x.dtype)


def interpolate_nearest_2d(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Nearest resize [N,C,H,W] -> [N,C,Ho,Wo]: source index floor(dst *
    in/out), the reference's F.interpolate default (Hopenet's 224 input)."""
    if tuple(out_hw) == tuple(x.shape[-2:]):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="nearest")


def resize_bilinear_half(x: torch.Tensor) -> torch.Tensor:
    """scale 0.5 bilinear downsample [N,C,H,W] (align_corners=False, no
    antialiasing: the 2x2 average), the perceptual loss's pyramid step."""
    H, W = x.shape[-2:]
    return interpolate_bilinear_2d(x, (H // 2, W // 2))


def upsample_nearest_2d(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """[N,C,H,W] nearest upsample (pixel duplication)."""
    return F.interpolate(x, scale_factor=scale, mode="nearest")


def upsample_nearest_3d(x: torch.Tensor, scale=(1, 2, 2)) -> torch.Tensor:
    """[N,C,D,H,W] nearest upsample; the reference upsamples only H,W."""
    return F.interpolate(x, scale_factor=tuple(scale), mode="nearest")


def avg_pool_2d(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """[N,C,H,W] non-overlapping average pool."""
    return F.avg_pool2d(x, window)


def avg_pool_3d(x: torch.Tensor, window=(1, 2, 2)) -> torch.Tensor:
    """[N,C,D,H,W] non-overlapping average pool (F.avg_pool3d with stride =
    window: trailing rows that fill no window are dropped); the reference
    pools only H,W.  A reshape and a mean over each window, averaged in fp32
    at least and returned in x's dtype, as the JAX package's mean does: its
    backward is a broadcast, deterministic on the card, where
    avg_pool3d_backward_cuda has no deterministic implementation (and
    PyTorch's CPU avg_pool3d takes no bf16)."""
    (a, b, c), (N, C, D, H, W) = window, x.shape
    d, h, w = D // a, H // b, W // c
    y = x[:, :, :d * a, :h * b, :w * c].to(torch.promote_types(x.dtype, torch.float32))
    return y.reshape(N, C, d, a, h, b, w, c).mean((3, 5, 7)).to(x.dtype)


def max_pool_2d(x: torch.Tensor, window: int = 3, stride: int = 2,
                padding: int = 1) -> torch.Tensor:
    """[N,C,H,W] max pool; the padding acts as -inf."""
    return F.max_pool2d(x, window, stride, padding)
