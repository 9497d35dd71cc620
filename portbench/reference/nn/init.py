"""Seeded parameter initialization (port of facevae_tpu/nn/init.py).

Conv and dense kernels and biases draw U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
torch's default distribution, but from an explicit ``torch.Generator`` so a
random model is a function of its seed.
"""
from __future__ import annotations

import math

import torch


@torch.no_grad()
def uniform_fan_in_(tensor: torch.Tensor, fan_in: int, generator: torch.Generator):
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    return tensor.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def unit_normal_(tensor: torch.Tensor, generator: torch.Generator, eps: float = 1e-12):
    """A random direction: normal draws scaled to unit L2 norm (the
    spectral-norm u/v start)."""
    tensor.normal_(generator=generator)
    return tensor.div_(tensor.norm() + eps)


def init_parameters(module: torch.nn.Module, generator: torch.Generator):
    """Initialize every layer of ``module`` that has an
    ``init_parameters(generator)`` method, in ``module.modules()`` order.
    The generator must live on the parameters' device."""
    for m in module.modules():
        if m is not module and hasattr(m, "init_parameters"):
            m.init_parameters(generator)
    return module
