"""Pattern-string conv blocks (port of facevae_tpu/nn/blocks.py), NC(D)HW.

Pattern chars: C = conv (optionally spectral-normed), N = norm (batch /
instance / none), A = nonlinearity (relu / leakyrelu 0.2).  The norm has
out_channels if C precedes N in the pattern, else in_channels.

Submodules carry the names flax gives their counterparts (``Conv_0``,
``BatchNorm_0``, ``ConvBlock_1``, ...), so a JAX variable path names its
PyTorch parameter directly (convert.py).  3D blocks pool / upsample H,W only.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.nn.layers import BatchNorm, Conv, InstanceNorm
from portbench.reference.ops.interpolate import (
    avg_pool_2d, avg_pool_3d, upsample_nearest_2d, upsample_nearest_3d,
)


class ConvBlock(nn.Module):
    def __init__(self, pattern, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, use_weight_norm=False, dim=2, norm_type="batch",
                 nonlinearity_type="relu", device=None):
        super().__init__()
        if nonlinearity_type not in ("relu", "leakyrelu"):
            raise ValueError(nonlinearity_type)
        self.pattern = pattern
        self.nonlinearity_type = nonlinearity_type
        self.norm_name = None
        c_pos, n_pos = pattern.find("C"), pattern.find("N")
        norm_channels = (out_channels if 0 <= c_pos < n_pos or n_pos < 0
                         else in_channels)
        for ch in pattern:
            if ch == "C":
                self.Conv_0 = Conv(in_channels, out_channels, kernel_size, stride,
                                   padding, dim=dim, spectral_norm=use_weight_norm,
                                   device=device)
            elif ch == "N":
                if norm_type == "batch":
                    self.norm_name = "BatchNorm_0"
                    self.BatchNorm_0 = BatchNorm(norm_channels, device=device)
                elif norm_type == "instance":
                    self.norm_name = "InstanceNorm_0"
                    self.InstanceNorm_0 = InstanceNorm(norm_channels, device=device)
                elif norm_type != "none":
                    raise ValueError(norm_type)
            elif ch != "A":
                raise ValueError(ch)

    def forward(self, x):
        for ch in self.pattern:
            if ch == "C":
                x = self.Conv_0(x)
            elif ch == "N":
                if self.norm_name is not None:
                    x = getattr(self, self.norm_name)(x)
            elif self.nonlinearity_type == "relu":
                x = F.relu(x)
            else:
                x = F.leaky_relu(x, 0.2)
        return x


class DownBlock2D(nn.Module):
    """conv3x3 CNA + avgpool 2."""

    def __init__(self, in_channels, out_channels, use_weight_norm=False, device=None):
        super().__init__()
        self.ConvBlock_0 = ConvBlock("CNA", in_channels, out_channels, 3, 1, 1,
                                     use_weight_norm, dim=2, device=device)

    def forward(self, x):
        return avg_pool_2d(self.ConvBlock_0(x), 2)


class DownBlock3D(nn.Module):
    """conv3x3x3 CNA + avgpool (1,2,2)."""

    def __init__(self, in_channels, out_channels, use_weight_norm=False, device=None):
        super().__init__()
        self.ConvBlock_0 = ConvBlock("CNA", in_channels, out_channels, 3, 1, 1,
                                     use_weight_norm, dim=3, device=device)

    def forward(self, x):
        return avg_pool_3d(self.ConvBlock_0(x), (1, 2, 2))


class UpBlock2D(nn.Module):
    """nearest upsample 2 + conv3x3 CNA."""

    def __init__(self, in_channels, out_channels, use_weight_norm=False, device=None):
        super().__init__()
        self.ConvBlock_0 = ConvBlock("CNA", in_channels, out_channels, 3, 1, 1,
                                     use_weight_norm, dim=2, device=device)

    def forward(self, x):
        return self.ConvBlock_0(upsample_nearest_2d(x, 2))


class UpBlock3D(nn.Module):
    """nearest upsample (1,2,2) + conv3x3x3 CNA."""

    def __init__(self, in_channels, out_channels, use_weight_norm=False, device=None):
        super().__init__()
        self.ConvBlock_0 = ConvBlock("CNA", in_channels, out_channels, 3, 1, 1,
                                     use_weight_norm, dim=3, device=device)

    def forward(self, x):
        return self.ConvBlock_0(upsample_nearest_3d(x, (1, 2, 2)))


class SameBlock2D(nn.Module):
    """1x1 conv CNA."""

    def __init__(self, in_channels, out_channels, use_weight_norm=False, device=None):
        super().__init__()
        self.ConvBlock_0 = ConvBlock("CNA", in_channels, out_channels, 1, 1, 0,
                                     use_weight_norm, dim=2, device=device)

    def forward(self, x):
        return self.ConvBlock_0(x)


class SameBlock3D(nn.Module):
    """1x1x1 conv CNA."""

    def __init__(self, in_channels, out_channels, use_weight_norm=False, device=None):
        super().__init__()
        self.ConvBlock_0 = ConvBlock("CNA", in_channels, out_channels, 1, 1, 0,
                                     use_weight_norm, dim=3, device=device)

    def forward(self, x):
        return self.ConvBlock_0(x)


class _ResBlock(nn.Module):
    """Pre-activation NAC-NAC residual."""

    dim = 2

    def __init__(self, channels, use_weight_norm=False, device=None):
        super().__init__()
        self.ConvBlock_0 = ConvBlock("NAC", channels, channels, 3, 1, 1,
                                     use_weight_norm, dim=self.dim, device=device)
        self.ConvBlock_1 = ConvBlock("NAC", channels, channels, 3, 1, 1,
                                     use_weight_norm, dim=self.dim, device=device)

    def forward(self, x):
        return x + self.ConvBlock_1(self.ConvBlock_0(x))


class ResBlock2D(_ResBlock):
    dim = 2


class ResBlock3D(_ResBlock):
    dim = 3


class ResBottleneck(nn.Module):
    """ResNet bottleneck; a CN 1x1 shortcut when the shape changes."""

    def __init__(self, in_channels, out_channels, stride=1, use_weight_norm=False,
                 device=None):
        super().__init__()
        mid = out_channels // 4
        names = iter(f"ConvBlock_{i}" for i in range(4))
        self.shortcut = None
        if stride != 1 or in_channels != out_channels:
            self.shortcut = next(names)
            self.add_module(self.shortcut, ConvBlock(
                "CN", in_channels, out_channels, 1, stride, 0, use_weight_norm,
                dim=2, device=device))
        self.body = [next(names) for _ in range(3)]
        self.add_module(self.body[0], ConvBlock("CNA", in_channels, mid, 1, 1, 0,
                                                use_weight_norm, dim=2, device=device))
        self.add_module(self.body[1], ConvBlock("CNA", mid, mid, 3, stride, 1,
                                                use_weight_norm, dim=2, device=device))
        self.add_module(self.body[2], ConvBlock("CN", mid, out_channels, 1, 1, 0,
                                                use_weight_norm, dim=2, device=device))

    def forward(self, x):
        shortcut = x if self.shortcut is None else self.get_submodule(self.shortcut)(x)
        h = x
        for name in self.body:
            h = self.get_submodule(name)(h)
        return torch.relu(shortcut + h)


def named_sequence(parent: nn.Module, prefix: str, modules, start: int = 0):
    """Register ``modules`` on ``parent`` as ``{prefix}_{start + i}`` (the
    flax auto-names) and return them as a plain list, in call order."""
    modules = list(modules)
    for i, m in enumerate(modules):
        parent.add_module(f"{prefix}_{start + i}", m)
    return modules
