"""Weight-normalized and untied-bias layers (port of facevae_tpu/nn/wn.py,
the reference's models_utils.py:116-132, 205-281, 747-835).  No model of
the port builds them; they are the library surface of the vendored code.

  LinearWN / Conv2dWN / ConvTranspose2dWN: weight normalization by ONE
    global Frobenius norm, sqrt(sum(w^2)) over the whole tensor in fp32
    (not per output unit, so not torch.nn.utils.weight_norm), times a gain g
    per output channel: w_eff = w * g / ||w||_F.  g runs along axis 0 of
    [out, in, *k] and along axis 1 of the transposed layouts [in, out, *k].
  *UB: an untied bias, one value per output channel and output position;
    *WNUB: both.  One class, _Conv, behind the JAX package's six factories.
  downsample2d: a depthwise binomial-7 blur; dilate2d: a depthwise box blur
    clipped at 1 (a soft mask dilation).
  fuse_wn(module): folds each WN layer's g into its weight in place.

Activations are NC(D)HW; weights are in torch's layouts, which are also the
JAX package's, so the bridge (convert.py) carries them as they are: each
class sets ``weight_as_is``.  The untied bias keeps the JAX package's
layout, [*spatial, out], and is added to the NC(D)HW output moved to [out,
*spatial]: the bridge carries it as it is, both ways.  Mixed precision as
the port's Conv: the effective weight and the biases are cast to the
input's dtype (LinearWN computes in the promotion of the input's dtype and
fp32, as jnp.matmul does).
"""
from __future__ import annotations

import math
from typing import Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from facevae_tpu_torch import numerics
from facevae_tpu_torch.nn.init import uniform_fan_in_

_CONV = {2: F.conv2d, 3: F.conv3d}
_CONV_T = {2: F.conv_transpose2d, 3: F.conv_transpose3d}
_BINOMIAL7 = (1.0, 6.0, 15.0, 20.0, 15.0, 6.0, 1.0)


def _wn(weight, g, axis):
    """weight * g / ||weight||_F, the norm over the whole tensor in fp32, g
    broadcast along ``axis``."""
    wnorm = torch.sqrt(torch.sum(weight.float() ** 2))
    shape = [1] * weight.dim()
    shape[axis] = -1
    return weight * (g.reshape(shape) / wnorm).to(weight.dtype)


class _WeightNormed(nn.Module):
    """A weight in torch's layout with an optional WN gain g along
    ``g_axis``, and a bias of ``bias_shape`` (None: no bias).  A vector bias
    draws U(+-1/sqrt(fan_in)), an untied one starts at zero."""

    weight_as_is = True

    def __init__(self, weight_shape, fan_in, bias_shape, weight_norm, g_axis, device):
        super().__init__()
        self.fan_in, self.weight_norm, self.g_axis = fan_in, weight_norm, g_axis
        self.weight = nn.Parameter(torch.empty(weight_shape, device=device))
        if weight_norm:
            self.g = nn.Parameter(torch.empty(weight_shape[g_axis], device=device))
        self.bias = (nn.Parameter(torch.empty(bias_shape, device=device))
                     if bias_shape is not None else None)

    @torch.no_grad()
    def init_parameters(self, generator):
        uniform_fan_in_(self.weight, self.fan_in, generator)
        if self.weight_norm:
            self.g.fill_(1.0)
        if self.bias is not None:
            if self.bias.dim() == 1:
                uniform_fan_in_(self.bias, self.fan_in, generator)
            else:
                self.bias.zero_()

    def effective_weight(self):
        return _wn(self.weight, self.g, self.g_axis) if self.weight_norm else self.weight

    @torch.no_grad()
    def fuse(self):
        """Store the effective weight w * g / ||w||_F (the reference's
        fuse()) and set g to its norm, so the forward, which normalizes
        again, is unchanged."""
        w_eff = self.effective_weight()
        self.weight.copy_(w_eff)
        self.g.copy_(torch.sqrt(torch.sum(w_eff.float() ** 2)).expand_as(self.g))


class LinearWN(_WeightNormed):
    """Weight-normalized linear over the last axis (reference
    models_utils.py:116-132)."""

    def __init__(self, in_features, out_features, bias=True, device=None):
        super().__init__((out_features, in_features), in_features,
                         (out_features,) if bias else None, True, 0, device)

    def forward(self, x):
        w = self.effective_weight()
        y = x.to(torch.promote_types(x.dtype, w.dtype)) @ w.t()
        return y if self.bias is None else y + self.bias


class _Conv(_WeightNormed):
    """Conv or transposed conv in ``dim`` dims, WN and / or untied bias: the
    one class behind Conv2dWN, ConvTranspose2dWN and the six UB factories
    (keyword arguments stride, padding, device).  ``spatial`` (the output's
    (H, W) or (D, H, W)) gives an untied bias [*spatial, out]."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 dim=2, transpose=False, weight_norm=True, spatial=None, device=None):
        k = (kernel_size,) * dim
        shape = (in_channels, out_channels) + k if transpose else (out_channels, in_channels) + k
        bias_shape = (out_channels,) if spatial is None else tuple(spatial) + (out_channels,)
        super().__init__(shape, in_channels * math.prod(k), bias_shape, weight_norm,
                         1 if transpose else 0, device)
        self.dim, self.stride, self.padding, self.transpose = dim, stride, padding, transpose
        self.untied = spatial is not None

    def forward(self, x):
        w = self.effective_weight().to(x.dtype)
        bias = None if self.untied else self.bias.to(x.dtype)
        if self.transpose:
            y = _CONV_T[self.dim](x, w, bias, self.stride, self.padding)
        else:
            y = _CONV[self.dim](x, w, bias, self.stride, self.padding)
        if self.untied:
            y = y + self.bias.movedim(-1, 0).to(y.dtype)
        return y


class Conv2dWN(_Conv):
    """reference models_utils.py:244-255."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding, device=device)


class ConvTranspose2dWN(_Conv):
    """reference models_utils.py:747-771."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding,
                         transpose=True, device=device)


def _untied(in_channels, out_channels, spatial, kernel_size, transpose, weight_norm, kw):
    return _Conv(in_channels, out_channels, kernel_size, dim=len(spatial), transpose=transpose,
                 weight_norm=weight_norm, spatial=spatial, **kw)


def Conv2dUB(in_channels, out_channels, height, width, kernel_size, **kw):
    """reference models_utils.py:257-267."""
    return _untied(in_channels, out_channels, (height, width), kernel_size, False, False, kw)


def Conv2dWNUB(in_channels, out_channels, height, width, kernel_size, **kw):
    """reference models_utils.py:269-281."""
    return _untied(in_channels, out_channels, (height, width), kernel_size, False, True, kw)


def ConvTranspose2dUB(in_channels, out_channels, height, width, kernel_size, **kw):
    """reference models_utils.py:773-783."""
    return _untied(in_channels, out_channels, (height, width), kernel_size, True, False, kw)


def ConvTranspose2dWNUB(in_channels, out_channels, height, width, kernel_size, **kw):
    """reference models_utils.py:785-811."""
    return _untied(in_channels, out_channels, (height, width), kernel_size, True, True, kw)


def Conv3dUB(in_channels, out_channels, depth, height, width, kernel_size, **kw):
    """reference models_utils.py:813-823."""
    return _untied(in_channels, out_channels, (depth, height, width), kernel_size, False, False,
                   kw)


def ConvTranspose3dUB(in_channels, out_channels, depth, height, width, kernel_size, **kw):
    """reference models_utils.py:825-835."""
    return _untied(in_channels, out_channels, (depth, height, width), kernel_size, True, False,
                   kw)


def downsample2d_kernel(dtype=torch.float32, device=None) -> torch.Tensor:
    """The normalized binomial-7 blur kernel [7, 7] (models_utils.py:213-215),
    made in fp32 and cast to ``dtype``."""
    b = numerics.constant(_BINOMIAL7, device=device)
    k = b[:, None] * b[None, :]
    return (k / k.sum()).to(dtype)


def downsample2d(x, stride: int = 1, padding: Union[int, str] = 0):
    """Depthwise binomial blur of x [N,C,H,W] (the reference's Downsample2d,
    models_utils.py:205-224); padding an int, or "reflect": 3 px of
    reflection, then no padding."""
    C = x.shape[1]
    w = downsample2d_kernel(x.dtype, x.device).expand(C, 1, 7, 7)
    if padding == "reflect":
        x = F.pad(x, (3, 3, 3, 3), mode="reflect")
        padding = 0
    return F.conv2d(x, w, None, stride, padding, groups=C)


def dilate2d(x, kernel_size: int, stride: int = 1, padding: int = 0):
    """Depthwise box blur of x [N,C,H,W], clipped at 1 (the reference's
    Dilate2d, models_utils.py:226-242)."""
    C = x.shape[1]
    w = torch.full((C, 1, kernel_size, kernel_size), 1.0 / kernel_size ** 2,
                   dtype=x.dtype, device=x.device)
    return torch.clamp(F.conv2d(x, w, None, stride, padding, groups=C), max=1.0)


def fuse_wn(module: nn.Module) -> nn.Module:
    """Fold every WN layer of ``module`` (itself included) in place: the
    stored weight becomes w * g / ||w||_F and g its norm; the forward is
    unchanged.  Each layer knows its g axis, so square transposed layers
    fold too (the JAX package's fuse_wn needs their paths)."""
    for m in module.modules():
        if isinstance(m, _WeightNormed) and m.weight_norm:
            m.fuse()
    return module
