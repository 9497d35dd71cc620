"""Perceptual loss: pixel L1 + VGG-Face L1 / 255 + VGG19 L1 + an image
pyramid (port of facevae_tpu/losses/perceptual.py).

Quirk q3 is kept by default: the reference's pyramid loop reuses stale loop
variables, so the extra scales apply only relu_5_1 with weight 1;
fixed_pyramid=True applies every layer weight at every scale.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from facevae_tpu_torch.losses.vgg import VGG16_BLOCKS, VGG19_BLOCKS, VGGFeatures
from facevae_tpu_torch.ops.interpolate import resize_bilinear_half
from facevae_tpu_torch.ops.normalization import (
    apply_imagenet_normalization, apply_vggface_normalization,
)

LAYER_WEIGHTS = {"relu_1_1": 0.03125, "relu_2_1": 0.0625, "relu_3_1": 0.125,
                 "relu_4_1": 0.25, "relu_5_1": 1.0}


def _l1(a, b):
    return torch.mean(torch.abs(a.float() - b.detach().float()))


def _nchw(x):
    return x.permute(0, 3, 1, 2)


class PerceptualLoss(nn.Module):
    """loss(inp, target) with inp, target [N,H,W,3] in [0,1]; the target's
    features carry no gradient (they are detached in the loss)."""

    def __init__(self, n_scales=3, fixed_pyramid=False, device=None):
        super().__init__()
        self.n_scales = n_scales
        self.fixed_pyramid = fixed_pyramid
        self.vgg19 = VGGFeatures(VGG19_BLOCKS, device=device)
        self.vggface = VGGFeatures(VGG16_BLOCKS, device=device)

    def forward(self, inp, target):
        min_size = 16 * (2 ** self.n_scales)
        if min(inp.shape[1:3]) < min_size:
            raise ValueError(
                f"PerceptualLoss with n_scales={self.n_scales} needs inputs "
                f">={min_size}px, got {tuple(inp.shape[1:3])}; lower LossConfig.n_scales")
        loss = torch.mean(torch.abs(inp.float() - target.float()))
        inp_n = _nchw(apply_imagenet_normalization(inp))
        f_in = self.vggface(_nchw(apply_vggface_normalization(inp)))
        g_in = self.vgg19(inp_n)
        with torch.no_grad():
            tgt_n = _nchw(apply_imagenet_normalization(target))
            f_tg = self.vggface(_nchw(apply_vggface_normalization(target)))
            g_tg = self.vgg19(tgt_n)
        for layer, weight in LAYER_WEIGHTS.items():
            loss = loss + weight * _l1(f_in[layer], f_tg[layer]) / 255.0
            loss = loss + weight * _l1(g_in[layer], g_tg[layer])
        x, y = inp_n, tgt_n
        for _ in range(self.n_scales):
            x = resize_bilinear_half(x)
            y = resize_bilinear_half(y)
            gi = self.vgg19(x)
            with torch.no_grad():
                gt = self.vgg19(y)
            if self.fixed_pyramid:
                for layer, weight in LAYER_WEIGHTS.items():
                    loss = loss + weight * _l1(gi[layer], gt[layer])
            else:   # quirk q3: only the last (layer, weight)
                loss = loss + LAYER_WEIGHTS["relu_5_1"] * _l1(gi["relu_5_1"], gt["relu_5_1"])
        return loss
