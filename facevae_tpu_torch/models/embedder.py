"""NeRF positional encoding (port of facevae_tpu/models/embedder.py): the
linear EFE variants embed the pose-only keypoints with it."""
from __future__ import annotations

import torch


def get_embedder(multires: int, include_input: bool = True,
                 log_sampling: bool = True, input_dims: int = 3):
    """(embed, out_dim): embed(x [..., input_dims]) concatenates x (with
    include_input) and sin(x f), cos(x f) for each of ``multires``
    frequencies f, 2^0 .. 2^(multires-1) (log_sampling: geometric, else
    evenly spaced), along the last axis; out_dim is its width."""
    max_freq = multires - 1
    if log_sampling:
        freq_bands = 2.0 ** torch.linspace(0.0, max_freq, multires)
    else:
        freq_bands = torch.linspace(2.0 ** 0.0, 2.0 ** max_freq, multires)
    freqs = freq_bands.tolist()
    out_dim = (input_dims if include_input else 0) + 2 * multires * input_dims

    def embed(x: torch.Tensor) -> torch.Tensor:
        parts = [x] if include_input else []
        for f in freqs:
            parts.append(torch.sin(x * f))
            parts.append(torch.cos(x * f))
        return torch.cat(parts, dim=-1)

    return embed, out_dim
