"""Equalized-learning-rate layers (port of facevae_tpu/nn/elr.py), used by
the dormant EFE variants and their VAEs.

The weight is stored as N(0,1) draws (LinearELR: divided by lrmult) in
torch's own layouts, which are also the JAX package's: Conv2dELR [out, in,
k, k], the transposed convs [in, out, *k], LinearELR [out, in].  The
forward multiplies it by a gain: the activation's gain (sqrt 2 for relu,
sqrt(2 / 1.04) for leakyrelu 0.2, else 1) times 1/sqrt(fan_in) (LinearELR:
times lrmult too), or, with norm="demod", the activation's gain alone on
the weight normalized per output unit (the transposed convs: times
stride^(d/2)).  Activations are NC(D)HW; the convs cast the scaled weight
and the bias to the input's dtype, LinearELR computes in the promotion of
the input's dtype and fp32, as jnp.matmul does.

The bridge (convert.py) carries ``weight`` across as it is, not as a flax
kernel: each class sets ``weight_as_is``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d, 3: F.conv_transpose3d}


def _act_gain(act: Optional[str]) -> float:
    if act == "relu":
        return math.sqrt(2.0)
    if act == "leakyrelu":
        return math.sqrt(2.0 / (1.0 + 0.2 * 0.2))
    return 1.0


def _apply_act(act: Optional[str], y):
    if act == "relu":
        return F.relu(y)
    if act == "leakyrelu":
        return F.leaky_relu(y, 0.2)
    return y


def _demod(w, dims):
    """w over its norm across ``dims`` (at least 1e-12)."""
    return w / torch.sqrt((w * w).sum(dims, keepdim=True)).clamp_min(1e-12)


class _ELR(nn.Module):
    weight_as_is = True

    def __init__(self, weight_shape, out_features, norm, act, device=None):
        super().__init__()
        self.norm, self.act = norm, act
        self.weight = nn.Parameter(torch.empty(weight_shape, device=device))
        self.bias = nn.Parameter(torch.empty(out_features, device=device))

    @torch.no_grad()
    def init_parameters(self, generator):
        self.weight.normal_(generator=generator)
        self.bias.zero_()


class Conv2dELR(_ELR):
    """Equalized-LR conv2d; demod normalizes over (in, kh, kw)."""

    def __init__(self, in_features, out_features, kernel_size, stride=1, padding=0,
                 norm=None, act=None, device=None):
        super().__init__((out_features, in_features, kernel_size, kernel_size),
                         out_features, norm, act, device)
        self.stride, self.padding = stride, padding
        self.fan_in = in_features * kernel_size * kernel_size

    def forward(self, x):
        gain = _act_gain(self.act)
        w = self.weight
        if self.norm == "demod":
            w = _demod(w, (1, 2, 3))
        else:
            gain = gain / math.sqrt(self.fan_in)
        y = F.conv2d(x, (w * gain).to(x.dtype), None, self.stride, self.padding)
        return _apply_act(self.act, y + self.bias.to(y.dtype).reshape(1, -1, 1, 1))


class _ConvTransposeELR(_ELR):
    """Equalized-LR transposed conv in ``dim`` dims.  Initial weight: N(0,1)
    at kernel k // stride, repeated stride times along each spatial axis
    (blockinit); demod normalizes over (in, *kernel) per output channel."""

    dim = 2

    def __init__(self, in_features, out_features, kernel_size, stride, padding,
                 norm=None, act=None, device=None):
        super().__init__((in_features, out_features) + (kernel_size,) * self.dim,
                         out_features, norm, act, device)
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding
        self.in_features = in_features

    @torch.no_grad()
    def init_parameters(self, generator):
        k, s, d = self.kernel_size, self.stride, self.dim
        small = torch.empty(self.weight.shape[:2] + (k // s,) * d, device=self.weight.device)
        small.normal_(generator=generator)
        for axis in range(2, 2 + d):
            small = small.repeat_interleave(s, dim=axis)
        self.weight.copy_(small)
        self.bias.zero_()

    def forward(self, x):
        k, s, d = self.kernel_size, self.stride, self.dim
        gain = _act_gain(self.act)
        w = self.weight
        if self.norm == "demod":
            w = _demod(w, (0,) + tuple(range(2, 2 + d)))
            gain = gain * s ** (d / 2.0)
        else:
            gain = gain / math.sqrt(self.in_features * k ** d / s ** d)
        y = _CONV_T[d](x, (w * gain).to(x.dtype), None, s, self.padding)
        return _apply_act(self.act, y + self.bias.to(y.dtype).reshape((1, -1) + (1,) * d))


class ConvTranspose1dELR(_ConvTransposeELR):
    dim = 1


class ConvTranspose2dELR(_ConvTransposeELR):
    dim = 2


class ConvTranspose3dELR(_ConvTransposeELR):
    dim = 3


class UpSampleBlock3d(nn.Module):
    """ConvTranspose3dELR(4, 2, 1) of x0, plus the skip x1 (EFE_conv6's
    decoder)."""

    def __init__(self, in_features, out_features, norm=None, act="leakyrelu", device=None):
        super().__init__()
        self.upconv = ConvTranspose3dELR(in_features, out_features, 4, 2, 1, norm=norm,
                                         act=act, device=device)

    def forward(self, x0, x1):
        return self.upconv(x0) + x1


class LinearELR(_ELR):
    """Equalized-LR linear over the last axis; demod normalizes each output
    row."""

    def __init__(self, in_features, out_features, lrmult=1.0, norm=None, act=None,
                 device=None):
        super().__init__((out_features, in_features), out_features, norm, act, device)
        self.in_features, self.lrmult = in_features, lrmult

    @torch.no_grad()
    def init_parameters(self, generator):
        self.weight.normal_(generator=generator).div_(self.lrmult)
        self.bias.zero_()

    def forward(self, x):
        gain = _act_gain(self.act)
        w = self.weight
        if self.norm == "demod":
            w = _demod(w, (1,))
        else:
            gain = gain * (1.0 / math.sqrt(self.in_features)) * self.lrmult
        x = x.to(torch.promote_types(x.dtype, w.dtype))
        return _apply_act(self.act, x @ (w * gain).t() + self.bias)
