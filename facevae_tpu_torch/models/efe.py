"""EFE — expression feature extractor, the conv family (port of
facevae_tpu/models/efe.py): variants conv, conv2, conv3, conv4 and conv5
(the active one), which differ in block composition:

  conv5  first down block a SameBlock2D, last up block a SameBlock3D,
         mid_conv reads the VAE's mu half, FlattenVAE_NL.
  conv4  DownBlock2Ds / UpBlock3Ds only, FlattenVAE over the flattened map
         (its latent of 256 must unflatten into the map: C*h*w = 256).
  conv3  DownBlock2Ds / UpBlock3Ds only, LocalVAE.
  conv2  no VAE; the contrastive features are the raw encoder maps.
  conv   no VAE; the contrastive features go through a stack of bare
         strided 3x3 convs (contra_seq, no norm or activation between
         them) and are flattened in torch's (C, h, w) order.

forward(x, x_a=None, kp_old, train_vae=False, eps=None, generator=None)
returns
  (kp [N,K,3], x_c, x_a_c, (mu, logstd), (x_vae, x_hat))
like the JAX module.  With x_a (the augmented view, training's contrastive
branch) the shared encoder runs on x and then on x_a, and x_c / x_a_c are
the two encoder maps, channel-last [N,h,w,C] like the JAX module's (the
contrastive head flattens them in that order; conv's are its flat
projections); without x_a they are None.  x_vae / x_hat are channel-last.
With train_vae the VAE samples (eps given, or drawn from ``generator``;
models/vae.py); without it z = mu (quirk q8: the reference trains with it
off).  kp is a soft-argmax over a heatmap mixed with gaussians of the
pose-only keypoints kp_old.  The JAX module's space-to-depth packing of the
tail is a TPU layout of the same math and is not ported.

image_size fixes the encoder map's size, which conv3's LocalVAE and conv4's
FlattenVAE are built for and which ``x_c_dim`` (the flattened width of x_c,
what the contrastive head must take) reports.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from facevae_tpu_torch.models.vae import FlattenVAE, FlattenVAE_NL, LocalVAE
from facevae_tpu_torch.nn import (Conv, DownBlock2D, ResBlock3D, SameBlock2D,
                                  SameBlock3D, UpBlock3D, named_sequence)
from facevae_tpu_torch.ops.heatmap import heatmap2kp_cl, kp2gaussian_3d_cl, out2heatmap_cl
from facevae_tpu_torch.ops.interpolate import interpolate_bilinear_2d

VARIANTS = ("conv", "conv2", "conv3", "conv4", "conv5")


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
                 scale_factor=0.25, use_vae=True, contra_seq: Optional[Sequence[int]] = None,
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
        self.contra = []
        self.x_c_dim = C * hw * hw
        if variant == "conv":
            cseq = tuple(contra_seq or (C, 512, 1024, 2048))
            self.contra = named_sequence(self, "contra", [
                Conv(cseq[i], cseq[i + 1], 3, 2, 1, dim=2, device=device)
                for i in range(len(cseq) - 1)])
            chw = hw
            for _ in self.contra:
                chw = (chw - 1) // 2 + 1
            self.x_c_dim = cseq[-1] * chw * chw
        self.vae = None
        z_channels = C
        if use_vae and variant not in ("conv", "conv2"):
            if variant == "conv5":
                self.vae = FlattenVAE_NL()
                z_channels = C // 2
            elif variant == "conv4":
                if C * hw * hw != 256:
                    raise ValueError(
                        f"EFE conv4 at {image_size}x{image_size}: FlattenVAE's latent of 256 "
                        f"does not unflatten into the encoder map's C*h*w = {C}*{hw}*{hw} = "
                        f"{C * hw * hw} (the JAX module fails on the same reshape; "
                        "efe_down_seq[-1] = 64 fits at 256x256)")
                self.vae = FlattenVAE(down_seq=(C * hw * hw, 256), device=device)
            else:
                self.vae = LocalVAE(C, hw, use_weight_norm=use_weight_norm, device=device)
                z_channels = self.vae.out_channels
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

    def _project(self, f):
        """conv's contrastive projection, flattened in (C, h, w) order."""
        for conv in self.contra:
            f = conv(f)
        return f.reshape(f.shape[0], -1)

    def forward(self, x, x_a=None, kp_old=None, train_vae: bool = False,
                eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        x = self.down(x.permute(0, 3, 1, 2))
        x_c = x_a_c = None
        if x_a is not None:               # second call of the shared encoder
            x_a_map = self.down(x_a.permute(0, 3, 1, 2))
            if self.variant == "conv":
                x_c, x_a_c = self._project(x), self._project(x_a_map)
            else:
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
