"""VAE bottleneck of EFE_conv5 (port of facevae_tpu/models/vae.py:27-42).

Only the active, parameter-free FlattenVAE_NL is ported: mu is the first
half of the channels and, with train_vae=False, z = mu.  The sampling path
(train_vae=True, the ``sample`` inference mode) and the dormant FlattenVAE /
LocalVAE wait for later PRs (ROADMAP).
"""
from __future__ import annotations

import torch.nn as nn


class FlattenVAE_NL(nn.Module):
    """x [N,2*Cz,h,w] -> ((mu, logstd), x_hat [N,Cz,h,w])."""

    def forward(self, x, train_vae: bool = False):
        if train_vae:
            raise NotImplementedError("FlattenVAE_NL sampling (train_vae=True) "
                                      "is not ported yet (ROADMAP Queue 1)")
        return (None, None), x[:, : x.shape[1] // 2]
