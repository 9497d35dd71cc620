"""Patch discriminator (port of facevae_tpu/models/discriminator.py).

Input is the image concatenated with 2D gaussian heatmaps of the keypoints
(detached): 3+K channels.  Four strided spectral-norm, instance-norm,
leaky-ReLU blocks, then a CN logits head.  Returns, channel-last like the
JAX module, (patch logits [N,h,w,1], [the four block outputs]) for the GAN
and feature-matching losses.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from facevae_tpu_torch.nn import ConvBlock
from facevae_tpu_torch.ops.heatmap import kp2gaussian_2d_cl


class Discriminator(nn.Module):
    def __init__(self, down_seq=(64, 128, 256, 512), K=15, use_weight_norm=True,
                 device=None):
        super().__init__()
        self.blocks = []
        chans = (3 + K,) + tuple(down_seq)
        for i in range(len(down_seq)):
            stride = 2 if i < len(down_seq) - 1 else 1
            block = ConvBlock("CNA", chans[i], chans[i + 1], 3, stride, 1, use_weight_norm,
                              dim=2, norm_type="instance", nonlinearity_type="leakyrelu",
                              device=device)
            self.add_module(f"block_{i}", block)
            self.blocks.append(block)
        self.head = ConvBlock("CN", down_seq[-1], 1, 3, 1, 1, use_weight_norm, dim=2,
                              norm_type="none", device=device)

    def forward(self, x, kp):
        heat = kp2gaussian_2d_cl(kp.detach()[:, :, :2], tuple(x.shape[1:3]))
        x = torch.cat([x, heat.to(x.dtype)], dim=-1).permute(0, 3, 1, 2)
        features = []
        for block in self.blocks:
            x = block(x)
            features.append(x.permute(0, 2, 3, 1))
        return self.head(x).permute(0, 2, 3, 1), features
