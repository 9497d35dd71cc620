"""VAE bottlenecks of the EFE variants (port of facevae_tpu/models/vae.py).

Each takes the encoder map x [N,C,h,w] and returns ((mu, logstd), x_hat
[N,C',h',w']):

  FlattenVAE_NL  conv5's, parameter-free: mu is the first half of the
                 channels, logstd the second.  (mu, logstd) come back
                 flattened [N, h*w*Cz] in the JAX package's channel-last
                 (h, w, c) order, the order its KL term and any caller's eps
                 are laid out in.
  FlattenVAE     conv4's: x flattened in torch's (C, h, w) order, LinearELR
                 demod + leakyrelu layers, mu = 0.1 * mu_fc, logstd = 0.01 *
                 logstd_fc, z unflattened to x's shape.
  FlattenVAE6    conv6's: the same with an ELR decoder after z; (mu,
                 logstd) always come back.
  LocalVAE       conv3's: DownBlock2D encoder, two LinearELR maps, UpBlock2D
                 decoder, no sampling (its reference forward has the VAE
                 core commented out); (None, None).

Without train_vae, z = mu and (mu, logstd) are (None, None) except in
FlattenVAE6 (quirk q8: the reference trains with it off).  With it, z = mu +
exp(logstd) * eps, eps the caller's or drawn from ``generator``
(torch.randn on the generator's device, then moved to x's): JAX's threefry
draws cannot be reproduced in torch, so the parity tests pass the same eps
to both packages.  The ELR layers compute in fp32 (jnp.matmul's promotion),
so under bf16 the maps after FlattenVAE, FlattenVAE6 and LocalVAE are fp32,
as in the JAX package.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from facevae_tpu_torch import remat
from facevae_tpu_torch.nn import DownBlock2D, UpBlock2D, named_sequence
from facevae_tpu_torch.nn.elr import LinearELR


def draw_eps(shape, device, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """N(0,1) draws of ``shape`` from ``generator`` (on its device), on
    ``device``; under remat drawn once, in the forward (remat.once)."""
    def draw():
        gen_device = generator.device if generator is not None else device
        return torch.randn(shape, generator=generator, device=gen_device).to(device)
    return remat.once(draw)


def _sample(mu, logstd, eps, generator):
    """mu + exp(logstd) * eps, eps given or drawn; checks its shape."""
    if eps is None:
        eps = draw_eps(logstd.shape, mu.device, generator)
    if tuple(eps.shape) != tuple(logstd.shape):
        raise ValueError(f"eps {tuple(eps.shape)} does not match logstd "
                         f"{tuple(logstd.shape)}")
    return mu + torch.exp(logstd) * eps.to(device=mu.device, dtype=logstd.dtype)


class FlattenVAE_NL(nn.Module):
    """x [N,2*Cz,h,w] -> ((mu, logstd), x_hat [N,Cz,h,w]); (None, None)
    unless train_vae."""

    def forward(self, x, train_vae: bool = False, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        half = x.shape[1] // 2
        if not train_vae:
            return (None, None), x[:, :half]
        N, _, h, w = x.shape
        cl = x.permute(0, 2, 3, 1)                          # the JAX layout [N,h,w,2Cz]
        mu = cl[..., :half].reshape(N, -1)
        logstd = cl[..., half:].reshape(N, -1)
        z = _sample(mu, logstd, eps, generator)
        return (mu, logstd), z.reshape(N, h, w, half).permute(0, 3, 1, 2)


def _unflatten(z, like):
    """z [N, C*h*w] in (C, h, w) order -> like's [N,C,h,w]; refuses a size
    that does not fit (the JAX module fails on its reshape there)."""
    size = like.shape[1:].numel()
    if z.shape[1] != size:
        raise ValueError(f"the VAE's latent of {z.shape[1]} does not unflatten into the "
                         f"encoder map's {tuple(like.shape[1:])} (C*h*w = {size})")
    return z.reshape(like.shape[0], *like.shape[1:])


class FlattenVAE(nn.Module):
    """ELR-encoder VAE over the flattened map (reference flatten_vae)."""

    def __init__(self, down_seq: Sequence[int] = (16 * 4 * 4, 256),
                 vae_seq: Sequence[int] = (256, 256), device=None):
        super().__init__()
        self.down = named_sequence(self, "LinearELR", [
            LinearELR(down_seq[i], down_seq[i + 1], norm="demod", act="leakyrelu",
                      device=device) for i in range(len(down_seq) - 1)])
        self.mu_fc = LinearELR(vae_seq[0], vae_seq[1], device=device)
        self.logstd_fc = LinearELR(vae_seq[0], vae_seq[1], device=device)

    def forward(self, x, train_vae: bool = False, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        h = x.reshape(x.shape[0], -1)                      # torch's (C, h, w) order
        for layer in self.down:
            h = layer(h)
        mu = self.mu_fc(h) * 0.1
        if not train_vae:
            # the reference zeroes logstd and the noise: z = mu
            return (None, None), _unflatten(mu, x)
        logstd = self.logstd_fc(h) * 0.01
        z = _sample(mu, logstd, eps, generator)
        return (mu, logstd), _unflatten(z, x)


class FlattenVAE6(nn.Module):
    """ELR encoder / decoder VAE (reference flatten_vae6)."""

    def __init__(self, down_seq: Sequence[int] = (16 * 4 * 4, 256),
                 up_seq: Sequence[int] = (256, 16 * 4 * 4),
                 vae_seq: Sequence[int] = (256, 256), device=None):
        super().__init__()
        self.enc = named_sequence(self, "enc", [
            LinearELR(down_seq[i], down_seq[i + 1], norm="demod", act="leakyrelu",
                      device=device) for i in range(len(down_seq) - 1)])
        self.mu_fc = LinearELR(vae_seq[0], vae_seq[1], device=device)
        self.logstd_fc = LinearELR(vae_seq[0], vae_seq[1], device=device)
        self.dec = named_sequence(self, "dec", [
            LinearELR(up_seq[i], up_seq[i + 1], norm="demod", act="leakyrelu",
                      device=device) for i in range(len(up_seq) - 1)])

    def forward(self, x, train_vae: bool = True, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        h = x.reshape(x.shape[0], -1)
        for layer in self.enc:
            h = layer(h)
        mu = self.mu_fc(h) * 0.1
        logstd = self.logstd_fc(h) * 0.01
        z = _sample(mu, logstd, eps, generator) if train_vae else mu
        for layer in self.dec:
            z = layer(z)
        return (mu, logstd), _unflatten(z, x)


class LocalVAE(nn.Module):
    """Conv encoder / decoder passthrough (reference local_vae).  in_channels
    and in_hw are x's channels and spatial size (the JAX module reads them
    off its input)."""

    def __init__(self, in_channels: int, in_hw: int, down_seq: Sequence[int] = (128, 128),
                 up_seq: Sequence[int] = (128, 128), vae_seq: Sequence[int] = (512, 256),
                 use_weight_norm: bool = False, device=None):
        super().__init__()
        chans = (in_channels,) + tuple(down_seq[1:])
        self.down = named_sequence(self, "DownBlock2D", [
            DownBlock2D(chans[i], chans[i + 1], use_weight_norm, device=device)
            for i in range(len(down_seq) - 1)])
        hw = in_hw
        for _ in self.down:
            hw //= 2
        if hw < 1:
            raise ValueError(f"LocalVAE: its {len(self.down)} DownBlock2D(s) leave no extent "
                             f"of a {in_hw}x{in_hw} map")
        self.up0 = up_seq[0]
        self.map_fc1 = LinearELR(chans[-1] * hw * hw, vae_seq[0], norm="demod",
                                 act="leakyrelu", device=device)
        self.map_fc2 = LinearELR(vae_seq[0], 128 * 4 * 4, norm="demod", act="leakyrelu",
                                 device=device)
        self.up = named_sequence(self, "UpBlock2D", [
            UpBlock2D(up_seq[i], up_seq[i + 1], use_weight_norm, device=device)
            for i in range(len(up_seq) - 1)])
        self.out_channels = up_seq[-1]

    def forward(self, x, train_vae: bool = False, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        h = x
        for block in self.down:
            h = block(h)
        flat = self.map_fc2(self.map_fc1(h.reshape(h.shape[0], -1)))
        h = flat.reshape(h.shape[0], self.up0, 4, 4)
        for block in self.up:
            h = block(h)
        return (None, None), h
