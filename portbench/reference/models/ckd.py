"""CKD — canonical keypoint detector (port of facevae_tpu/models/ckd.py).

Quarter-scale input -> 2D DownBlocks -> 1x1 conv to up_seq[0]*D channels ->
[N,up_seq[0],D,h,w] volume -> 3D UpBlocks -> conv3d to K heatmap channels ->
softmax heatmap -> soft-argmax keypoints [N,K,3].
"""
from __future__ import annotations

import torch.nn as nn

from portbench.reference.nn import Conv, DownBlock2D, UpBlock3D, named_sequence
from portbench.reference.ops.heatmap import heatmap2kp_cl, out2heatmap_cl
from portbench.reference.ops.interpolate import interpolate_bilinear_2d


class CKD(nn.Module):
    def __init__(self, down_seq=(3, 64, 128, 256, 512, 1024),
                 up_seq=(1024, 512, 256, 128, 64, 32), D=16, K=15,
                 scale_factor=0.25, use_weight_norm=False, device=None):
        super().__init__()
        self.D, self.up0, self.scale_factor = D, up_seq[0], scale_factor
        self.downs = named_sequence(self, "DownBlock2D", [
            DownBlock2D(down_seq[i], down_seq[i + 1], use_weight_norm, device=device)
            for i in range(len(down_seq) - 1)])
        self.Conv_0 = Conv(down_seq[-1], up_seq[0] * D, 1, dim=2, device=device)
        self.ups = named_sequence(self, "UpBlock3D", [
            UpBlock3D(up_seq[i], up_seq[i + 1], use_weight_norm, device=device)
            for i in range(len(up_seq) - 1)])
        self.Conv_1 = Conv(up_seq[-1], K, 3, 1, 1, dim=3, device=device)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        H, W = x.shape[-2:]
        x = interpolate_bilinear_2d(x, (int(H * self.scale_factor),
                                        int(W * self.scale_factor)))
        for block in self.downs:
            x = block(x)
        x = self.Conv_0(x)
        n, _, h, w = x.shape
        x = x.view(n, self.up0, self.D, h, w)
        for block in self.ups:
            x = block(x)
        x = self.Conv_1(x)                                    # [N,K,D,h,w]
        return heatmap2kp_cl(out2heatmap_cl(x.permute(0, 2, 3, 4, 1)))
