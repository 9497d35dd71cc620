"""Input normalization of the pretrained perceptual and pose teachers (port
of facevae_tpu/ops/normalization.py).  Channel-last [N,H,W,3]."""
from __future__ import annotations

import torch

from portbench.reference.numerics import constant

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)
_VGGFACE_MEAN = (129.186279296875, 104.76238250732422, 93.59396362304688)


def apply_imagenet_normalization(x: torch.Tensor) -> torch.Tensor:
    mean = constant(_IMAGENET_MEAN, x.dtype, x.device)
    std = constant(_IMAGENET_STD, x.dtype, x.device)
    return (x - mean) / std


def apply_vggface_normalization(x: torch.Tensor) -> torch.Tensor:
    mean = constant(_VGGFACE_MEAN, x.dtype, x.device)
    return x * 255.0 - mean
