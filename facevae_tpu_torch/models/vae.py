"""VAE bottleneck of EFE_conv5 (port of facevae_tpu/models/vae.py:27-42).

Only the active, parameter-free FlattenVAE_NL is ported: mu is the first
half of the channels and logstd the second.  With train_vae=False, z = mu
(quirk q8: the reference zeroes logstd and the noise).  With
train_vae=True, z = mu + exp(logstd) * eps, and (mu, logstd) come back
flattened [N, h*w*Cz] in the JAX package's channel-last (h, w, c) order,
the order its KL term and any caller's eps are laid out in.  The dormant
FlattenVAE / FlattenVAE6 / LocalVAE wait for a later PR (ROADMAP Queue 1).

eps is the caller's, or drawn from ``generator`` (torch.randn on the
generator's device, then moved to x's): JAX's threefry draws cannot be
reproduced in torch, so the parity tests pass the same eps to both
packages.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn


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
        if eps is None:
            device = generator.device if generator is not None else x.device
            eps = torch.randn(logstd.shape, generator=generator, device=device)
        if tuple(eps.shape) != tuple(logstd.shape):
            raise ValueError(f"eps {tuple(eps.shape)} does not match logstd "
                             f"{tuple(logstd.shape)} ([N, h*w*Cz], channel-last order)")
        z = mu + torch.exp(logstd) * eps.to(device=x.device, dtype=logstd.dtype)
        return (mu, logstd), z.reshape(N, h, w, half).permute(0, 3, 1, 2)
