"""Input normalization of the pretrained perceptual and pose teachers (port
of facevae_tpu/ops/normalization.py).  Channel-last [N,H,W,3]."""
from __future__ import annotations

import torch

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)
_VGGFACE_MEAN = (129.186279296875, 104.76238250732422, 93.59396362304688)


def apply_imagenet_normalization(x: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(_IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(_IMAGENET_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def apply_vggface_normalization(x: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(_VGGFACE_MEAN, dtype=x.dtype, device=x.device)
    return x * 255.0 - mean
