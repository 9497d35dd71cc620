"""EFE, the expression feature extractor: the conv5 variant of the
program's models/efe.py, the one the benchmark's configurations run (its
first down block a SameBlock2D, its last up block a SameBlock3D, mid_conv
reading the VAE's mu half, FlattenVAE_NL).  The program's other variants are
not copied.

forward(x, x_a=None, kp_old, train_vae=False, eps=None, generator=None)
returns (kp [N,K,3], x_c, x_a_c, (mu, logstd), (x_vae, x_hat)).  With x_a
(the augmented view) the shared encoder runs on x and then on x_a, and
x_c / x_a_c are the two encoder maps, channel-last [N,h,w,C]; without x_a
they are None.  With train_vae the VAE samples; without it z = mu.  kp is
a soft-argmax over a heatmap mixed with gaussians of the pose-only
keypoints kp_old.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from portbench.reference.models.vae import FlattenVAE_NL
from portbench.reference.nn import (Conv, DownBlock2D, ResBlock3D, SameBlock2D,
                                  SameBlock3D, UpBlock3D, named_sequence)
from portbench.reference.ops.heatmap import heatmap2kp_cl, kp2gaussian_3d_cl, out2heatmap_cl
from portbench.reference.ops.interpolate import interpolate_bilinear_2d

VARIANTS = ("conv5",)


class _Encoder(nn.Module):
    """Quarter-scale 2D encoder; conv5's first block is a SameBlock."""

    def __init__(self, variant, down_seq, scale_factor, use_weight_norm, device=None):
        super().__init__()
        self.scale_factor = scale_factor
        self.blocks = named_sequence(self, "down", [
            (SameBlock2D if variant == "conv5" and i == 0 else DownBlock2D)(
                down_seq[i], down_seq[i + 1], use_weight_norm, device=device)
            for i in range(len(down_seq) - 1)])

    def map_hw(self, image_size: int) -> int:
        """The encoder map's side for a square image of ``image_size``."""
        hw = int(image_size * self.scale_factor)
        for block in self.blocks:
            if isinstance(block, DownBlock2D):
                hw //= 2
        return hw

    def forward(self, x):
        H, W = x.shape[-2:]
        x = interpolate_bilinear_2d(x, (int(H * self.scale_factor),
                                        int(W * self.scale_factor)))
        for block in self.blocks:
            x = block(x)
        return x


class EFEConv(nn.Module):
    def __init__(self, variant="conv5", down_seq=(3, 32, 64, 128, 256, 32),
                 up_seq=(256, 256, 128, 64, 32, 32), D=16, K=15, n_res=3,
                 scale_factor=0.25, use_vae=True,
                 use_weight_norm=False, image_size=256, device=None):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"EFEConv variant {variant!r} is not one of {VARIANTS}")
        self.variant, self.D, self.K, self.up0 = variant, D, K, up_seq[0]
        self.down = _Encoder(variant, down_seq, scale_factor, use_weight_norm, device=device)
        C, hw = down_seq[-1], self.down.map_hw(image_size)
        if hw < 1:
            raise ValueError(f"EFE {variant} at {image_size}x{image_size}: the encoder map "
                             f"has no extent ({int(image_size * scale_factor)} px halved "
                             f"{sum(isinstance(b, DownBlock2D) for b in self.down.blocks)} "
                             "times)")
        self.x_c_dim = C * hw * hw
        self.vae = FlattenVAE_NL() if use_vae else None
        z_channels = C // 2 if use_vae else C
        self.mid_conv = Conv(z_channels, up_seq[0] * D, 1, dim=2, device=device)
        last = len(up_seq) - 2
        self.ups = named_sequence(self, "up", [
            (SameBlock3D if variant == "conv5" and i == last else UpBlock3D)(
                up_seq[i], up_seq[i + 1], use_weight_norm, device=device)
            for i in range(len(up_seq) - 1)])
        self.out_conv = Conv(up_seq[-1], K, 3, 1, 1, dim=3, device=device)
        self.mix = named_sequence(self, "mix", [
            ResBlock3D(2 * K, use_weight_norm, device=device) for _ in range(n_res)])
        self.mix_out = SameBlock3D(2 * K, K, use_weight_norm, device=device)

    def forward(self, x, x_a=None, kp_old=None, train_vae: bool = False,
                eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        x = self.down(x.permute(0, 3, 1, 2))
        x_c = x_a_c = None
        if x_a is not None:               # second call of the shared encoder
            x_a_map = self.down(x_a.permute(0, 3, 1, 2))
            x_c, x_a_c = x.permute(0, 2, 3, 1), x_a_map.permute(0, 2, 3, 1)
        mu = logstd = x_vae = x_hat = None
        x_z = x
        if self.vae is not None:
            x_vae = x.permute(0, 2, 3, 1)
            (mu, logstd), x_z = self.vae(x, train_vae, eps, generator)
            x_hat = x_z.permute(0, 2, 3, 1)
        x = self.mid_conv(x_z)
        n, _, h, w = x.shape
        x = x.view(n, self.up0, self.D, h, w)
        for block in self.ups:
            x = block(x)
        x = self.out_conv(x)                                   # [N,K,D,h,w]
        xc = kp2gaussian_3d_cl(kp_old, tuple(x.shape[2:]))     # [N,D,h,w,K]
        x = torch.cat([x, xc.permute(0, 4, 1, 2, 3).to(x.dtype)], dim=1)
        for block in self.mix:
            x = block(x)
        x = self.mix_out(x)
        kp = heatmap2kp_cl(out2heatmap_cl(x.permute(0, 2, 3, 4, 1)))
        return kp, x_c, x_a_c, (mu, logstd), (x_vae, x_hat)
