"""Frozen VGG feature stacks of the perceptual loss (port of
facevae_tpu/losses/vgg.py): conv / ReLU / max-pool blocks with the
relu_i_1 taps, truncated at relu_5_1, the deepest tap the loss reads.
NCHW inside; the weights are the JAX teacher trees bridged by convert.py."""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn

from facevae_tpu_torch.nn import Conv
from facevae_tpu_torch.ops.interpolate import max_pool_2d

VGG19_BLOCKS: Tuple[Tuple[int, ...], ...] = ((64, 64), (128, 128), (256, 256, 256, 256),
                                             (512, 512, 512, 512), (512,))
VGG16_BLOCKS: Tuple[Tuple[int, ...], ...] = ((64, 64), (128, 128), (256, 256, 256),
                                             (512, 512, 512), (512,))


class VGGFeatures(nn.Module):
    """x [N,3,H,W] -> {"relu_i_1": [N,C,h,w]} for i = 1..5."""

    def __init__(self, blocks=VGG19_BLOCKS, device=None):
        super().__init__()
        self.plan = []
        cin = 3
        for bi, widths in enumerate(blocks):
            for ci, width in enumerate(widths):
                name = f"conv{bi + 1}_{ci + 1}"
                self.add_module(name, Conv(cin, width, 3, 1, 1, device=device))
                self.plan.append((bi, ci, name))
                cin = width
        self.requires_grad_(False)

    def forward(self, x) -> Dict[str, torch.Tensor]:
        taps = {}
        for bi, ci, name in self.plan:
            if bi > 0 and ci == 0:
                x = max_pool_2d(x, 2, 2, 0)
            x = torch.relu(getattr(self, name)(x))
            if ci == 0:
                taps[f"relu_{bi + 1}_1"] = x
        return taps
