"""The conv5 EFE's VAE, FlattenVAE_NL, as the program's models/vae.py has
it: x [N,2*Cz,h,w] splits into mu and logstd halves; without train_vae z is
mu, with it z = mu + exp(logstd) * eps, eps given or drawn from an explicit
generator.  The program's other VAEs are not copied."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from portbench.reference import remat


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
