"""AFE — 3D appearance feature extractor (port of facevae_tpu/models/afe.py).

[N,H,W,3] -> 7x7 conv -> DownBlocks -> 1x1 conv to C*D channels -> the
[N,C,D,h,w] volume (channel k is (c = k // D, d = k % D): torch's
view(N, C, D, h, w)) -> ResBlock3Ds -> returned channel-last [N,D,h,w,C].
"""
from __future__ import annotations

import torch.nn as nn

from portbench.reference.nn import Conv, ConvBlock, DownBlock2D, ResBlock3D, named_sequence


class AFE(nn.Module):
    def __init__(self, down_seq=(64, 128, 256), n_res=6, C=32, D=16,
                 use_weight_norm=False, device=None):
        super().__init__()
        self.C, self.D = C, D
        self.ConvBlock_0 = ConvBlock("CNA", 3, down_seq[0], 7, 1, 3, use_weight_norm,
                                     dim=2, device=device)
        self.downs = named_sequence(self, "DownBlock2D", [
            DownBlock2D(down_seq[i], down_seq[i + 1], use_weight_norm, device=device)
            for i in range(len(down_seq) - 1)])
        self.Conv_0 = Conv(down_seq[-1], C * D, 1, dim=2, device=device)
        self.res = named_sequence(self, "ResBlock3D", [
            ResBlock3D(C, use_weight_norm, device=device) for _ in range(n_res)])

    def forward(self, x):
        x = self.ConvBlock_0(x.permute(0, 3, 1, 2))
        for block in self.downs:
            x = block(x)
        x = self.Conv_0(x)
        N, _, h, w = x.shape
        x = x.view(N, self.C, self.D, h, w)
        for block in self.res:
            x = block(x)
        return x.permute(0, 2, 3, 4, 1).contiguous()
