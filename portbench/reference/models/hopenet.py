"""Hopenet, the frozen head-pose teacher (port of
facevae_tpu/models/hopenet.py).

A torchvision-style ResNet-50 (bottlenecks [3,4,6,3], stride on the 3x3
conv) with 66-bin yaw / pitch / roll heads; returns the expected angles in
radians.  It always runs in eval form (running BatchNorm statistics), and
its weights are the JAX teacher tree bridged by convert.py: the port never
draws teacher weights of its own.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn

from portbench.reference.nn import BatchNorm, Conv, Dense
from portbench.reference.ops.interpolate import max_pool_2d


class _Bottleneck(nn.Module):
    def __init__(self, inplanes, planes, stride=1, downsample=False, device=None):
        super().__init__()
        out_ch = planes * 4
        self.conv1 = Conv(inplanes, planes, 1, 1, 0, bias=False, device=device)
        self.bn1 = BatchNorm(planes, device=device)
        self.conv2 = Conv(planes, planes, 3, stride, 1, bias=False, device=device)
        self.bn2 = BatchNorm(planes, device=device)
        self.conv3 = Conv(planes, out_ch, 1, 1, 0, bias=False, device=device)
        self.bn3 = BatchNorm(out_ch, device=device)
        self.downsample = downsample
        if downsample:
            self.downsample_conv = Conv(inplanes, out_ch, 1, stride, 0, bias=False,
                                        device=device)
            self.downsample_bn = BatchNorm(out_ch, device=device)

    def forward(self, x):
        h = torch.relu(self.bn1(self.conv1(x)))
        h = torch.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        identity = self.downsample_bn(self.downsample_conv(x)) if self.downsample else x
        return torch.relu(h + identity)


class Hopenet(nn.Module):
    def __init__(self, layers=(3, 4, 6, 3), num_bins=66, device=None):
        super().__init__()
        self.num_bins = num_bins
        self.conv1 = Conv(3, 64, 7, 2, 3, bias=False, device=device)
        self.bn1 = BatchNorm(64, device=device)
        self.blocks = []
        inplanes = 64
        for li, (planes, blocks) in enumerate(zip((64, 128, 256, 512), layers)):
            stride = 1 if li == 0 else 2
            for bi in range(blocks):
                block = _Bottleneck(inplanes, planes, stride if bi == 0 else 1,
                                    downsample=bi == 0 and (stride != 1 or inplanes != planes * 4),
                                    device=device)
                self.add_module(f"layer{li + 1}_{bi}", block)
                self.blocks.append(block)
                inplanes = planes * 4
        self.fc_yaw = Dense(inplanes, num_bins, device=device)
        self.fc_pitch = Dense(inplanes, num_bins, device=device)
        self.fc_roll = Dense(inplanes, num_bins, device=device)
        self.requires_grad_(False)
        self.eval()

    def train(self, mode: bool = True):
        """A frozen teacher: always in eval form."""
        return super().train(False)

    def _to_radians(self, logits):
        idx = torch.arange(self.num_bins, dtype=torch.float32, device=logits.device)
        expect = (torch.softmax(logits, dim=1) * idx).sum(dim=1)
        return (expect - self.num_bins // 2) * 3.0 * math.pi / 180.0

    def forward(self, x):
        """x [N,H,W,3] channel-last -> (yaw, pitch, roll) [N] in radians."""
        x = torch.relu(self.bn1(self.conv1(x.permute(0, 3, 1, 2))))
        x = max_pool_2d(x, 3, 2, 1)
        for block in self.blocks:
            x = block(x)
        x = x.mean(dim=(2, 3))
        return tuple(self._to_radians(fc(x).float())
                     for fc in (self.fc_yaw, self.fc_pitch, self.fc_roll))
