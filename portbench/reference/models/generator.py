"""Generator (port of facevae_tpu/models/generator.py).

Warps the appearance volume by the dense deformation (warp_single: the
single-grid warp of csrc/warp_grid.cu at fp32, the multi-grid warp of
csrc/warp_fwd.cu and warp_bwd.cu at K1=1 at bf16), folds depth into channels
c-major (torch's view(N, C*D, H, W): channel c*D + d), gates by the
occlusion map, then 2D res/up decoding to a sigmoid RGB image [N,H,W,3].
use_weight_norm puts spectral norm on the block convs; mid_conv and out_conv
are plain.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from portbench.reference.nn import Conv, ConvBlock, ResBlock2D, UpBlock2D, named_sequence
from portbench.reference.warp import warp_single


class Generator(nn.Module):
    def __init__(self, up_seq=(256, 128, 64), n_res=6, D=16, C=32,
                 use_weight_norm=True, device=None):
        super().__init__()
        self.in_conv = ConvBlock("CNA", C * D, up_seq[0], 3, 1, 1, use_weight_norm,
                                 dim=2, nonlinearity_type="leakyrelu", device=device)
        self.mid_conv = Conv(up_seq[0], up_seq[0], 1, dim=2, device=device)
        self.res = named_sequence(self, "res", [
            ResBlock2D(up_seq[0], use_weight_norm, device=device) for _ in range(n_res)])
        self.ups = named_sequence(self, "up", [
            UpBlock2D(up_seq[i], up_seq[i + 1], use_weight_norm, device=device)
            for i in range(len(up_seq) - 1)])
        self.out_conv = Conv(up_seq[-1], 3, 7, 1, 3, dim=2, device=device)

    def forward(self, fs, deformation, occlusion):
        N, D, H, W, C = fs.shape
        fs = warp_single(fs, deformation)                      # [N,D,H,W,C]
        fs = fs.permute(0, 4, 1, 2, 3).reshape(N, C * D, H, W)
        fs = self.mid_conv(self.in_conv(fs))
        fs = fs * occlusion.permute(0, 3, 1, 2)
        for block in self.res:
            fs = block(fs)
        for block in self.ups:
            fs = block(fs)
        return torch.sigmoid(self.out_conv(fs)).permute(0, 2, 3, 1)
