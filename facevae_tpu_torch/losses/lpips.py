"""LPIPS perceptual distance (port of facevae_tpu/losses/lpips.py): the
criterion of the dormant ContrastiveHeadConv (the reference's
ContrastiveLoss_conv, losses.py:284-286, taming's LPIPS).

A fixed scaling layer, a frozen VGG16 at full widths tapped at the last
ReLU of each block (relu1_2, relu2_2, relu3_3, relu4_3, relu5_3) with a 2x2
/ stride 2 max pool before blocks 2-5, unit-normalized feature differences
(the norm in fp32, eps 1e-10), bias-free 1x1 ``lin_i`` heads, a spatial
mean and the sum over the five taps.  The weights are a seeded random init
like the other teachers' (none are downloaded), or the JAX tree through
the bridge: the parameters keep its names, ``conv{b}_{c}`` and ``lin_{i}``.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from facevae_tpu_torch import numerics
from facevae_tpu_torch.nn import Conv
from facevae_tpu_torch.ops.interpolate import max_pool_2d

VGG16_FULL = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512), (512, 512, 512))

# taming's ScalingLayer constants (channel-last)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def _unit_normalize(x, eps=1e-10):
    """x over its fp32 L2 norm across channels (dim 1)."""
    return x / (torch.sqrt(torch.sum(x.float() ** 2, dim=1, keepdim=True)) + eps)


class LPIPS(nn.Module):
    """Frozen LPIPS distance: forward(x, y) with x, y [N,H,W,3] in [-1, 1]
    -> [N] fp32.  Its parameters get no gradient; its inputs do."""

    def __init__(self, device=None):
        super().__init__()
        self.plan = []
        cin = 3
        for bi, widths in enumerate(VGG16_FULL):
            for ci, width in enumerate(widths):
                name = f"conv{bi + 1}_{ci + 1}"
                self.add_module(name, Conv(cin, width, 3, 1, 1, device=device))
                self.plan.append((bi, ci, name))
                cin = width
        for i, widths in enumerate(VGG16_FULL):
            self.add_module(f"lin_{i}", Conv(widths[-1], 1, 1, 1, 0, bias=False, device=device))
        self.requires_grad_(False)

    def _taps(self, v):
        shift = numerics.constant(_SHIFT, v.dtype, v.device)
        scale = numerics.constant(_SCALE, v.dtype, v.device)
        v = ((v - shift) / scale).permute(0, 3, 1, 2)
        taps = []
        for bi, ci, name in self.plan:
            if bi > 0 and ci == 0:
                v = max_pool_2d(v, 2, 2, 0)
            v = torch.relu(getattr(self, name)(v))
            if ci == len(VGG16_FULL[bi]) - 1:
                taps.append(v)
        return taps

    def forward(self, x, y):
        total = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
        for i, (a, b) in enumerate(zip(self._taps(x), self._taps(y))):
            diff = (_unit_normalize(a) - _unit_normalize(b)) ** 2
            val = getattr(self, f"lin_{i}")(diff.to(x.dtype))
            total = total + val.float().mean(dim=(1, 2, 3))
        return total
