"""The port's numerics switches, stated in one place.

TF32 is off for both cuDNN convolutions and cuBLAS matmuls, so fp32 on the
card means full fp32 and the parity with the JAX reference holds.  Turning
TF32 on is a performance change for a later PR, measured against the parity
tolerances.
"""
from __future__ import annotations

import torch


def apply() -> dict:
    """Set the switches and return them as they now read."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return {
        "torch.backends.cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
        "torch.backends.cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
    }
