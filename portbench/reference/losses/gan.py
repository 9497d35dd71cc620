"""GAN hinge and feature-matching losses (port of facevae_tpu/losses/gan.py)."""
from __future__ import annotations

from typing import Sequence

import torch


def gan_loss_dis(dis_output: torch.Tensor, t_real: bool) -> torch.Tensor:
    """Hinge loss of the discriminator update: real -mean(min(x-1, 0)),
    fake -mean(min(-x-1, 0))."""
    x = dis_output.float()
    if t_real:
        return -torch.mean(torch.clamp(x - 1.0, max=0.0))
    return -torch.mean(torch.clamp(-x - 1.0, max=0.0))


def gan_loss_gen(dis_output: torch.Tensor) -> torch.Tensor:
    """Generator loss -mean(D(G))."""
    return -torch.mean(dis_output.float())


def feature_matching_loss(fake_features: Sequence[torch.Tensor],
                          real_features: Sequence[torch.Tensor]) -> torch.Tensor:
    """L1 over the discriminator's feature maps, real side detached.  Keeps
    the reference's double-indexing quirk: each feature weighs
    (batch / number of features) x its mean L1."""
    num_d = len(fake_features)
    loss = torch.zeros((), dtype=torch.float32, device=fake_features[0].device)
    for f, r in zip(fake_features, real_features):
        per = torch.mean(torch.abs(f.float() - r.detach().float()))
        loss = loss + (f.shape[0] / num_d) * per
    return loss
