"""EFE linear variants (port of facevae_tpu/models/efe_linear.py): "linear"
(reference EFE_linear) and "lin_conv" (reference EFE_lin_conv).

A quarter-scale DownBlock2D chain collapses the frame to one feature vector
(1x1 at 256x256; flattened in the JAX module's (h, w, c) order), which
demodulated LinearELR layers map, concatenated with the NeRF embedding of
the pose-only keypoints (get_embedder(10): 63 values a keypoint), straight
to K*3 tanh'd keypoint coordinates (no heatmap).

As in the JAX module:
  - quirk q2: "linear" has no contrastive branch (x_c = x_a_c = None);
  - "lin_conv" is built to the reference's evident intent (upstream it
    never assigns its encoder, its VAE reads a None input without x_a, and
    its augmented branch skips the quarter-scale resize): the encoder
    exists, the VAE (vae_seq, 4096 wide) reads the encoder's features, and
    both branches share the scaled encoder;
  - its VAE samples only with train_vae (eps given or drawn from
    ``generator``, models/vae.py), else z = mu (quirk q8).

forward returns the family's 5-tuple (kp, x_c, x_a_c, (mu, logstd), (None,
None)); x_c / x_a_c are flat [N, C*h*w].
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from facevae_tpu_torch.models.embedder import get_embedder
from facevae_tpu_torch.models.vae import _sample
from facevae_tpu_torch.nn import DownBlock2D, named_sequence
from facevae_tpu_torch.nn.elr import LinearELR
from facevae_tpu_torch.ops.interpolate import interpolate_bilinear_2d


class _FlatEncoder(nn.Module):
    """Quarter-scale DownBlock2D chain collapsed to a flat vector."""

    def __init__(self, down_seq, scale_factor, use_weight_norm, device=None):
        super().__init__()
        self.scale_factor = scale_factor
        self.blocks = named_sequence(self, "down", [
            DownBlock2D(down_seq[i], down_seq[i + 1], use_weight_norm, device=device)
            for i in range(len(down_seq) - 1)])

    def forward(self, x):
        H, W = x.shape[-2:]
        x = interpolate_bilinear_2d(x, (int(H * self.scale_factor),
                                        int(W * self.scale_factor)))
        for block in self.blocks:
            x = block(x)
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # the JAX (h, w, c) order


def _elr_stack(parent, prefix, seq, first_extra=0, device=None):
    return named_sequence(parent, prefix, [
        LinearELR(seq[i] + (first_extra if i == 0 else 0), seq[i + 1], norm="demod",
                  act="leakyrelu", device=device) for i in range(len(seq) - 1)])


class EFELinear(nn.Module):
    def __init__(self, variant="linear", down_seq: Sequence[int] = (3, 64, 128, 256, 512,
                                                                   1024, 2048),
                 vae_seq: Optional[Sequence[int]] = None, mid_seq: Sequence[int] = (2048, 512),
                 cat_seq: Sequence[int] = (512, 512), up_seq: Sequence[int] = (512, 512),
                 K=15, multires=10, scale_factor=0.25, use_weight_norm=False,
                 image_size=256, device=None):
        super().__init__()
        if variant not in ("linear", "lin_conv"):
            raise ValueError(f"EFELinear variant {variant!r} is not linear or lin_conv")
        self.variant, self.K = variant, K
        self.down = _FlatEncoder(down_seq, scale_factor, use_weight_norm, device=device)
        hw = int(image_size * scale_factor)
        for _ in range(len(down_seq) - 1):
            hw //= 2
        if hw < 1:
            raise ValueError(f"EFE {variant} at {image_size}x{image_size}: the encoder map "
                             f"has no extent ({int(image_size * scale_factor)} px halved "
                             f"{len(down_seq) - 1} times)")
        self.x_c_dim = None if variant == "linear" else down_seq[-1] * hw * hw
        self.vae_enc = []
        if vae_seq is not None:
            self.vae_enc = _elr_stack(self, "vae_enc", vae_seq, device=device)
            self.mu = LinearELR(vae_seq[-1], vae_seq[-1] // 2, device=device)
            self.logstd = LinearELR(vae_seq[-1], vae_seq[-1] // 2, device=device)
        self.has_vae = vae_seq is not None
        self.embed, per_kp = get_embedder(multires)
        self.mid_map = _elr_stack(self, "mid_map", mid_seq, device=device)
        self.mid_cat = _elr_stack(self, "mid_cat", cat_seq, first_extra=K * per_kp,
                                  device=device)
        self.ups = _elr_stack(self, "up", up_seq, device=device)
        self.final_linear = LinearELR(up_seq[-1], K * 3, device=device)

    def forward(self, x, x_a=None, kp_old=None, train_vae: bool = False,
                eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        feat = self.down(x.permute(0, 3, 1, 2))
        x_c = x_a_c = None
        if self.variant == "lin_conv" and x_a is not None:     # quirk q2 for "linear"
            x_c, x_a_c = feat, self.down(x_a.permute(0, 3, 1, 2))
        mu = logstd = None
        h = feat
        if self.has_vae:
            for layer in self.vae_enc:
                h = layer(h)
            mu, logstd = self.mu(h), self.logstd(h)
            h = _sample(mu, logstd, eps, generator) if train_vae else mu
        for layer in self.mid_map:
            h = layer(h)
        kp_emb = self.embed(kp_old).reshape(h.shape[0], -1)
        h = torch.cat([h, kp_emb.to(h.dtype)], dim=1)
        for layer in self.mid_cat + self.ups:
            h = layer(h)
        kp = torch.tanh(self.final_linear(h)).reshape(-1, self.K, 3)
        return kp, x_c, x_a_c, (mu, logstd), (None, None)


def efe_lin_conv_defaults():
    """The reference EFE_lin_conv's constructor defaults."""
    return dict(variant="lin_conv",
                down_seq=(3, 64, 128, 256, 512, 1024, 2048),
                vae_seq=(2048, 4096, 4096),
                mid_seq=(2048, 2048), cat_seq=(2048, 2048),
                up_seq=(2048, 2048, 2048, 2048))
