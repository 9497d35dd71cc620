"""HPE_EDE — head-pose estimator + scale head (port of
facevae_tpu/models/hpe_ede.py).

ResBottleneck stacks -> global mean pool -> 5 heads in fp32: yaw/pitch/roll
as 66-bin softmax expectations in radians, translation t [N,3], and a scalar
scale shaped [N,1,1,1].
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn

from facevae_tpu_torch.nn import ConvBlock, Dense, ResBottleneck, named_sequence
from facevae_tpu_torch.ops.interpolate import max_pool_2d


class HPE_EDE(nn.Module):
    def __init__(self, n_filters=(64, 256, 512, 1024, 2048), n_blocks=(3, 3, 5, 2),
                 n_bins=66, use_weight_norm=False, device=None):
        super().__init__()
        self.n_bins = n_bins
        self.ConvBlock_0 = ConvBlock("CNA", 3, n_filters[0], 7, 2, 3, use_weight_norm,
                                     dim=2, device=device)
        blocks = []
        for i in range(len(n_filters) - 1):
            blocks.append(ResBottleneck(n_filters[i], n_filters[i + 1], 1 if i == 0 else 2,
                                        use_weight_norm, device=device))
            blocks += [ResBottleneck(n_filters[i + 1], n_filters[i + 1], 1,
                                     use_weight_norm, device=device)
                       for _ in range(n_blocks[i])]
        self.blocks = named_sequence(self, "ResBottleneck", blocks)
        F = n_filters[-1]
        self.fc_yaw = Dense(F, n_bins, device=device)
        self.fc_pitch = Dense(F, n_bins, device=device)
        self.fc_roll = Dense(F, n_bins, device=device)
        self.fc_t = Dense(F, 3, device=device)
        self.fc_scale = Dense(F, 1, device=device)

    def _to_radians(self, logits):
        idx = torch.arange(self.n_bins, dtype=torch.float32, device=logits.device)
        expect = (torch.softmax(logits, dim=1) * idx).sum(dim=1)
        return (expect - self.n_bins // 2) * 3.0 * math.pi / 180.0

    def forward(self, x):
        x = self.ConvBlock_0(x.permute(0, 3, 1, 2))
        x = max_pool_2d(x, 3, 2, 1)
        for block in self.blocks:
            x = block(x)
        x = x.mean(dim=(2, 3))                                  # [N,F]
        yaw = self._to_radians(self.fc_yaw(x).float())
        pitch = self._to_radians(self.fc_pitch(x).float())
        roll = self._to_radians(self.fc_roll(x).float())
        t = self.fc_t(x).float()
        scale = self.fc_scale(x).float().reshape(x.shape[0], 1, 1, 1)
        return yaw, pitch, roll, t, scale
