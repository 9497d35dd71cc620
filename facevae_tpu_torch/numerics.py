"""The port's numerics switches, stated in one place, and its constant
tensors.

TF32 is off for both cuDNN convolutions and cuBLAS matmuls, so fp32 on the
card means full fp32 and the parity with the JAX reference holds.  Turning
TF32 on is a performance change for a later PR, measured against the parity
tolerances.
"""
from __future__ import annotations

import functools

import torch


def apply() -> dict:
    """Set the switches and return them as they now read."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return {
        "torch.backends.cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
        "torch.backends.cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
    }


@functools.lru_cache(maxsize=None)
def _constant(values, dtype, device):
    return torch.tensor(values, dtype=dtype, device=device)


def constant(values, dtype=torch.float32, device=None) -> torch.Tensor:
    """The tensor torch.tensor(values, dtype, device) makes, made once per
    (values, dtype, device) and shared: later calls copy nothing from the
    host, which a CUDA graph's capture forbids (train/scan.py captures
    after a first eager step).  Read-only: never write into it."""
    return _constant(values, dtype, torch.device(device or "cpu"))
