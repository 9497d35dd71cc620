"""EFE — expression feature extractor, variant conv5 (port of
facevae_tpu/models/efe.py).

forward(x, x_a=None, kp_old, train_vae=False, eps=None, generator=None)
returns
  (kp [N,K,3], x_c, x_a_c, (mu, logstd), (x_vae, x_hat))
like the JAX module.  With x_a (the augmented view, training's contrastive
branch) the shared encoder runs on x and then on x_a, and x_c / x_a_c are
the two encoder maps, channel-last [N,h,w,C] like the JAX module's (the
contrastive head flattens them in that order); without x_a they are None.
x_vae / x_hat are channel-last.  With train_vae the VAE samples z = mu +
exp(logstd) * eps (eps given, or drawn from ``generator``) and mu / logstd
are [N, h*w*Cz] in the JAX module's channel-last order; without it they are
None and z = mu (quirk q8: the reference trains with it off).  kp is a
soft-argmax over a heatmap mixed with gaussians of the pose-only keypoints
kp_old.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from facevae_tpu_torch.models.vae import FlattenVAE_NL
from facevae_tpu_torch.nn import (Conv, DownBlock2D, ResBlock3D, SameBlock2D,
                                  SameBlock3D, UpBlock3D, named_sequence)
from facevae_tpu_torch.ops.heatmap import heatmap2kp_cl, kp2gaussian_3d_cl, out2heatmap_cl
from facevae_tpu_torch.ops.interpolate import interpolate_bilinear_2d


class _Encoder(nn.Module):
    """Quarter-scale 2D encoder; conv5's first block is a SameBlock."""

    def __init__(self, down_seq, scale_factor, use_weight_norm, device=None):
        super().__init__()
        self.scale_factor = scale_factor
        self.blocks = named_sequence(self, "down", [
            (SameBlock2D if i == 0 else DownBlock2D)(
                down_seq[i], down_seq[i + 1], use_weight_norm, device=device)
            for i in range(len(down_seq) - 1)])

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
                 scale_factor=0.25, use_vae=True, use_weight_norm=False, device=None):
        super().__init__()
        if variant != "conv5" or not use_vae:
            raise NotImplementedError(
                f"EFE variant {variant!r} (use_vae={use_vae}) is not ported yet; "
                "only conv5 with its VAE is (ROADMAP Queue 1, dormant variants)")
        self.D, self.K, self.up0 = D, K, up_seq[0]
        self.down = _Encoder(down_seq, scale_factor, use_weight_norm, device=device)
        self.vae = FlattenVAE_NL()
        self.mid_conv = Conv(down_seq[-1] // 2, up_seq[0] * D, 1, dim=2, device=device)
        last = len(up_seq) - 2
        self.ups = named_sequence(self, "up", [
            (SameBlock3D if i == last else UpBlock3D)(
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
            x_c = x.permute(0, 2, 3, 1)
            x_a_c = self.down(x_a.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        x_vae = x
        (mu, logstd), x_hat = self.vae(x, train_vae, eps, generator)
        x = self.mid_conv(x_hat)
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
        return (kp, x_c, x_a_c, (mu, logstd),
                (x_vae.permute(0, 2, 3, 1), x_hat.permute(0, 2, 3, 1)))
