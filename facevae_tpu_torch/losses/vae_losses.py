"""VAE losses (port of facevae_tpu/losses/vae_losses.py)."""
from __future__ import annotations

import torch


def kl_divergence_loss(mu: torch.Tensor, logstd: torch.Tensor) -> torch.Tensor:
    """KL(N(mu, exp(logstd)) || N(0, 1)), mean over dims, then batch."""
    mu, logstd = mu.float(), logstd.float()
    kl = -0.5 - logstd + 0.5 * mu ** 2 + 0.5 * torch.exp(2.0 * logstd)
    return kl.mean(dim=-1).mean()


def recon_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """MSE; the step feeds (d, generated_d)."""
    return torch.mean((a.float() - b.float()) ** 2)
