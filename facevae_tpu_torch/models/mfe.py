"""MFE — motion field estimator (port of facevae_tpu/models/mfe.py).

Compresses the appearance volume C1 -> C2 channels, builds K+1 heatmap
differences and K+1 warped sources (k=0 is the identity warp, an exact copy
concatenated without warping; k>=1 go through ONE warp_multi_pixel call),
runs a 3D hourglass over the k-major packing [heat_k, deformed_k(C2)], and
returns, channel-last like the JAX module:
  deformation [N,D,H,W,3] = sum_k mask_k * motion_k (fp32)
  occlusion   [N,H,W,1]   = sigmoid(2D conv over torch's view(N, C*D, H, W))
  mask        [N,D,H,W,K+1] (softmax, fp32)
The JAX module's depth-folded / z-banded execution of the two output convs
is the same function of the same parameters: here they are a plain 7^3
Conv3d and a Conv2d over the c-major depth fold.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from facevae_tpu_torch.nn import Conv, DownBlock3D, UpBlock3D, named_sequence
from facevae_tpu_torch.ops.fast_warp import warp_multi_pixel
from facevae_tpu_torch.ops.motion import (
    blend_deformation, create_heatmap_representations_cl, motion_affine_params,
    sparse_motion_pixel_coords,
)


class MFE(nn.Module):
    def __init__(self, down_seq=(80, 64, 128, 256, 512, 1024),
                 up_seq=(1024, 512, 256, 128, 64, 32), K=15, D=16, C1=32, C2=4,
                 use_weight_norm=False, device=None):
        super().__init__()
        self.K, self.C2 = K, C2
        self.compress = Conv(C1, C2, 1, dim=3, device=device)
        self.downs = named_sequence(self, "DownBlock3D", [
            DownBlock3D(down_seq[i], down_seq[i + 1], use_weight_norm, device=device)
            for i in range(len(down_seq) - 1)])
        self.ups = named_sequence(self, "UpBlock3D", [
            UpBlock3D(up_seq[i], up_seq[i + 1], use_weight_norm, device=device)
            for i in range(len(up_seq) - 1)])
        cat_ch = down_seq[0] + up_seq[-1]
        self.mask_conv = Conv(cat_ch, K + 1, 7, 1, 3, dim=3, device=device)
        self.occlusion_conv = Conv(cat_ch * D, 1, 7, 1, 3, dim=2, device=device)

    def forward(self, fs, kp_s, kp_d, Rs, Rd):
        N, D, H, W, _ = fs.shape
        K1, C2 = self.K + 1, self.C2
        # the 1x1x1 compress conv on the channel-last volume is a matmul
        fs_c = F.linear(fs, self.compress.weight.flatten(1), self.compress.bias)

        heatmap = create_heatmap_representations_cl(fs_c, kp_s, kp_d)  # [N,D,H,W,K1]
        jac, b = motion_affine_params(kp_s, kp_d, Rs, Rd)
        cgx, cgy, cgz = sparse_motion_pixel_coords((D, H, W), jac, b,
                                                   include_identity=False)
        deformed_rest = warp_multi_pixel(fs_c, cgx, cgy, cgz, (D, H, W))  # [..,K*C2]
        deformed = torch.cat([fs_c.to(deformed_rest.dtype), deformed_rest], dim=-1)
        per_k = torch.cat([heatmap[..., None].to(deformed.dtype),
                           deformed.reshape(N, D, H, W, K1, C2)], dim=-1)
        inp = per_k.reshape(N, D, H, W, K1 * (1 + C2)).permute(0, 4, 1, 2, 3).contiguous()

        x = inp
        for block in self.downs:
            x = block(x)
        for block in self.ups:
            x = block(x)
        x = torch.cat([inp, x], dim=1)                         # [N,C,D,H,W]

        mask = torch.softmax(self.mask_conv(x).float(), dim=1).permute(0, 2, 3, 4, 1)
        deformation = blend_deformation(mask, jac, b)
        occlusion = torch.sigmoid(self.occlusion_conv(x.reshape(N, -1, H, W)))
        return deformation, occlusion.permute(0, 2, 3, 1), mask
