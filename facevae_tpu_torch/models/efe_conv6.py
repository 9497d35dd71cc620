"""EFE_conv6 — the ELR / pyramid expression extractor variant (port of
facevae_tpu/models/efe_conv6.py).

A Conv2dELR encoder (demod + leakyrelu; the reference's k1-s1-p1 stem, then
four k4-s2-p1 convs) to a [N,16,4,4] map, the FlattenVAE6 bottleneck, and
a decoder whose transposed-conv stages double depth and spatial size alike
(16,4,4 -> 256,64,64), each adding a level of a pyramid of 3D conv blocks
over the keypoint gaussians, which the reference renders at a hard-coded
(256, 64, 64) volume.  So it takes 256x256 images only and refuses others,
as the JAX module does.  Returns the family's 5-tuple (models/efe.py); x_c
/ x_a_c are the channel-last encoder maps, [N,4,4,16].
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from facevae_tpu_torch.models.vae import FlattenVAE6
from facevae_tpu_torch.nn import Conv, ConvBlock, SameBlock3D, named_sequence
from facevae_tpu_torch.nn.elr import Conv2dELR, UpSampleBlock3d
from facevae_tpu_torch.ops.heatmap import heatmap2kp_cl, kp2gaussian_3d_cl, out2heatmap_cl
from facevae_tpu_torch.ops.interpolate import interpolate_bilinear_2d

IMAGE_SIZE = 256
GAUSSIAN_VOLUME = (256, 64, 64)


class _ELREncoder(nn.Module):
    def __init__(self, demod=True, device=None):
        super().__init__()
        norm = "demod" if demod else None
        seq = (3, 32, 64, 128, 256, 16)
        self.layers = named_sequence(self, "enc", [
            Conv2dELR(seq[0], seq[1], 1, 1, 1, norm=norm, act="leakyrelu", device=device)] + [
            Conv2dELR(seq[i], seq[i + 1], 4, 2, 1, norm=norm, act="leakyrelu", device=device)
            for i in range(1, 5)])

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class EFEConv6(nn.Module):
    def __init__(self, D=16, K=15, scale_factor=0.25, use_vae=True, use_weight_norm=False,
                 demod=True, image_size=IMAGE_SIZE, device=None):
        super().__init__()
        if image_size != IMAGE_SIZE:
            raise ValueError(f"EFE_conv6 hard-codes {IMAGE_SIZE}x{IMAGE_SIZE} shapes (its "
                             f"gaussian volume {GAUSSIAN_VOLUME}); got image_size {image_size}")
        self.D, self.K, self.scale_factor = D, K, scale_factor
        self.efe_encoder = _ELREncoder(demod, device=device)
        hw = int(image_size * scale_factor) + 2            # the k1-p1 stem widens by 2
        for _ in range(4):
            hw = (hw + 2 - 4) // 2 + 1
        self.x_c_dim = 16 * hw * hw
        self.vae = FlattenVAE6(device=device) if use_vae else None
        up_seq = (256, 128, 128, 64, 32, K)
        self.up0 = up_seq[0]
        self.mid_conv = Conv(16, up_seq[0] * D, 1, dim=2, device=device)
        kpc = (K, 32, 64, 128, 128)
        uw = use_weight_norm
        self.kpc_64 = ConvBlock("CNA", kpc[0], kpc[1], 1, 1, 0, uw, dim=3,
                                nonlinearity_type="leakyrelu", device=device)
        self.kpc_32 = ConvBlock("CNA", kpc[1], kpc[2], 4, 2, 1, uw, dim=3,
                                nonlinearity_type="leakyrelu", device=device)
        self.kpc_16 = ConvBlock("CNA", kpc[2], kpc[3], 4, 2, 1, uw, dim=3,
                                nonlinearity_type="leakyrelu", device=device)
        self.kpc_8 = ConvBlock("CNA", kpc[3], kpc[4], 4, 2, 1, uw, dim=3,
                               nonlinearity_type="leakyrelu", device=device)
        self.dec_8 = UpSampleBlock3d(up_seq[0], up_seq[1], device=device)
        self.dec_16 = UpSampleBlock3d(up_seq[1], up_seq[2], device=device)
        self.dec_32 = UpSampleBlock3d(up_seq[2], up_seq[3], device=device)
        self.dec_64 = UpSampleBlock3d(up_seq[3], up_seq[4], device=device)
        self.efe_out = SameBlock3D(up_seq[4], up_seq[5], uw, device=device)

    def _encode(self, x):
        H, W = x.shape[-2:]
        x = interpolate_bilinear_2d(x, (int(H * self.scale_factor), int(W * self.scale_factor)))
        return self.efe_encoder(x)

    def forward(self, x, x_a=None, kp_old=None, train_vae: bool = False,
                eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        if x.shape[1] != IMAGE_SIZE:
            raise ValueError(f"EFE_conv6 hard-codes {IMAGE_SIZE}x{IMAGE_SIZE} shapes; got "
                             f"{tuple(x.shape)}")
        h = self._encode(x.permute(0, 3, 1, 2))                  # [N,16,4,4]
        x_c = x_a_c = None
        if x_a is not None:
            x_c = h.permute(0, 2, 3, 1)
            x_a_c = self._encode(x_a.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        mu = logstd = x_vae = x_hat = None
        x_z = h
        if self.vae is not None:
            x_vae = h.permute(0, 2, 3, 1)
            (mu, logstd), x_z = self.vae(h, train_vae, eps, generator)
            x_hat = x_z.permute(0, 2, 3, 1)
        h = self.mid_conv(x_z)
        n, _, hh, ww = h.shape
        h = h.view(n, self.up0, self.D, hh, ww)
        xc = kp2gaussian_3d_cl(kp_old, GAUSSIAN_VOLUME).permute(0, 4, 1, 2, 3).to(h.dtype)
        xc64 = self.kpc_64(xc)
        xc32 = self.kpc_32(xc64)
        xc16 = self.kpc_16(xc32)
        xc8 = self.kpc_8(xc16)
        h = self.dec_8(h, xc8)
        h = self.dec_16(h, xc16)
        h = self.dec_32(h, xc32)
        h = self.dec_64(h, xc64)
        h = self.efe_out(h)
        kp = heatmap2kp_cl(out2heatmap_cl(h.permute(0, 2, 3, 4, 1)))
        return kp, x_c, x_a_c, (mu, logstd), (x_vae, x_hat)
