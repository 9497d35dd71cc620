"""Constant tensors made once per (values, dtype, device)."""
from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def _constant(values, dtype, device):
    return torch.tensor(values, dtype=dtype, device=device)


def constant(values, dtype=torch.float32, device=None) -> torch.Tensor:
    return _constant(values, dtype, torch.device(device or "cpu"))
