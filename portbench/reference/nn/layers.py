"""Core layers: Conv (2D/3D, optional spectral norm), Dense, BatchNorm,
InstanceNorm (port of facevae_tpu/nn/layers.py).

Layouts are PyTorch's: weights [O, I, *k], activations [N, C, (D,) H, W].
The JAX package's TPU execution paths — space-to-depth packing, z-banded and
depth-folded convs, the MXU weight gradient — compute the same function with
the same parameters and are not ported: each is a plain conv here.

Mixed precision follows the JAX layers too: parameters stay fp32 and Conv
and Dense cast weight and bias to the input's dtype per call (a
spectral-norm weight is divided by its fp32 sigma first; u, v stay fp32);
BatchNorm and InstanceNorm take their statistics in fp32 and apply them in
the input's dtype.

Training forms follow the JAX layers: BatchNorm normalizes by the biased
batch variance and updates its running statistics in place; a spectral-norm
Conv runs one power iteration per training forward.  The buffers a forward
updates in place stand in for the JAX package's VarBank: calls see each
other's updates in call order.  Under remat (facevae_tpu_torch/remat.py) a
recompute advances neither: it takes the u, v and the batch statistics of
its forward.  BatchNorm synchronizes over ``group`` when it is set.
"""
from __future__ import annotations

import math
import warnings

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_fn
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference import remat
from portbench.reference.nn.init import unit_normal_, uniform_fan_in_

_CONV = {2: F.conv2d, 3: F.conv3d}
# torch marks its differentiable all-reduce deprecated in favour of the
# functional collectives, whose all_reduce has no gradient
warnings.filterwarnings("ignore", message="torch.distributed.nn.functional.all_reduce is "
                        "deprecated", category=FutureWarning)


def _tuple(v, d):
    return (v,) * d if isinstance(v, int) else tuple(v)


def _l2norm(v, eps=1e-12):
    return v / (torch.linalg.vector_norm(v) + eps)


class Conv(nn.Module):
    """2D/3D convolution.  With spectral_norm=True the weight is divided by
    sigma = u^T W v.  In training mode one power iteration first updates the
    stored u and v in place (without gradient); gradients flow through W
    only.  In eval mode the stored u and v are used as they are.  weight_v is
    kept in torch's (I, *k) flattening of W."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 dim=2, bias=True, spectral_norm=False, device=None):
        super().__init__()
        self.dim = dim
        self.stride = _tuple(stride, dim)
        self.padding = _tuple(padding, dim)
        ks = _tuple(kernel_size, dim)
        self.fan_in = in_channels * math.prod(ks)
        self.spectral_norm = spectral_norm
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, *ks, device=device))
        self.bias = (nn.Parameter(torch.empty(out_channels, device=device))
                     if bias else None)
        if spectral_norm:
            self.register_buffer("weight_u", torch.empty(out_channels, device=device))
            self.register_buffer("weight_v", torch.empty(self.fan_in, device=device))

    @torch.no_grad()
    def init_parameters(self, generator, power_iterations=20):
        uniform_fan_in_(self.weight, self.fan_in, generator)
        if self.bias is not None:
            uniform_fan_in_(self.bias, self.fan_in, generator)
        if self.spectral_norm:
            # Random u, v then power iterations, so sigma estimates the spectral
            # norm as a trained checkpoint's u, v do.  (The JAX init stops at
            # random u, v; its eval forward then divides by a near-zero sigma.)
            unit_normal_(self.weight_u, generator)
            unit_normal_(self.weight_v, generator)
            w = self.weight.flatten(1)
            for _ in range(power_iterations):
                self.weight_v.copy_(F.normalize(w.t() @ self.weight_u, dim=0))
                self.weight_u.copy_(F.normalize(w @ self.weight_v, dim=0))

    @torch.no_grad()
    def _power_iteration(self, w_mat):
        """One power iteration of the stored u, v in place; returns clones
        of them: the next training call updates u, v in place, while the
        backward of this call still needs them (their version counters)."""
        self.weight_v.copy_(_l2norm(w_mat.t() @ self.weight_u))
        self.weight_u.copy_(_l2norm(w_mat @ self.weight_v))
        return self.weight_u.clone(), self.weight_v.clone()

    def forward(self, x):
        w = self.weight
        if self.spectral_norm:
            w_mat = w.flatten(1)
            if self.training:
                # a remat recompute takes the u, v of its forward, unmoved
                u, v = remat.once(lambda: self._power_iteration(w_mat))
            else:
                u, v = self.weight_u.clone(), self.weight_v.clone()
            sigma = torch.dot(u, w_mat @ v)
            w = w / sigma
        return _CONV[self.dim](x, w.to(x.dtype), _cast(self.bias, x), self.stride,
                               self.padding)


def _cast(p, x):
    return None if p is None else p.to(x.dtype)


class Dense(nn.Linear):
    """nn.Linear with the seeded init, applied in the input's dtype."""

    def reset_parameters(self):
        pass                      # init_parameters(generator) does it, seeded

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), _cast(self.bias, x))

    def init_parameters(self, generator):
        uniform_fan_in_(self.weight, self.in_features, generator)
        if self.bias is not None:
            uniform_fan_in_(self.bias, self.in_features, generator)


def _per_channel(v, x):
    return v.reshape((1, -1) + (1,) * (x.dim() - 2))


class BatchNorm(nn.Module):
    """BatchNorm over dim 1 (channels) of [N, C, ...] or [N, C].

    Training: statistics E[x] and E[x^2] - E[x]^2 in fp32, normalization by
    that biased variance, and the running statistics updated in place with
    the unbiased variance and momentum 0.1 (new = 0.9 * old + 0.1 * batch).
    Eval: the running statistics.  Either way the statistics and the affine
    fold into one per-channel multiply-add, y = x * a + b.  affine=False has
    no weight or bias (the SimSiam projector's last BN).

    With ``group`` set (SyncBatchNorm, the JAX layer's axis_name): E[x] and
    E[x^2] are averaged over the group's ranks by one differentiable
    all-reduce (the backward all-reduces their cotangents, as the transpose
    of JAX's pmean), and the running variance's n counts every rank's
    elements.  Not torch's nn.SyncBatchNorm: that merges counts Welford-style
    and updates the running variance by another formula."""

    def __init__(self, features, eps=1e-5, momentum=0.1, affine=True, device=None):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.affine = affine
        if affine:
            self.weight = nn.Parameter(torch.empty(features, device=device))
            self.bias = nn.Parameter(torch.empty(features, device=device))
        self.register_buffer("running_mean", torch.empty(features, device=device))
        self.register_buffer("running_var", torch.empty(features, device=device))
        self.group = None

    @torch.no_grad()
    def init_parameters(self, generator):
        if self.affine:
            self.weight.fill_(1.0)
            self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    @torch.no_grad()
    def _update_running(self, mean, var, n):
        """The running statistics' update from one batch's; returns the
        batch's (mean, var)."""
        m = self.momentum
        self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
        self.running_var.copy_((1 - m) * self.running_var
                               + m * (var * (n / max(n - 1.0, 1.0))))
        return mean, var

    def forward(self, x):
        if self.training:
            dims = (0,) + tuple(range(2, x.dim()))
            xf = x.float()
            mean = xf.mean(dims)
            mean2 = (xf * xf).mean(dims)
            world = 1
            if self.group is not None:
                world = dist.get_world_size(self.group)
                stats = dist_fn.all_reduce(torch.stack([mean, mean2]), group=self.group)
                mean, mean2 = (stats / world).unbind(0)
            var = mean2 - mean * mean
            n = float(x.numel() // x.shape[1] * world)
            # a remat recompute updates nothing and uses its forward's values
            kept = remat.once(lambda: self._update_running(mean, var, n))
            mean, var = remat.pin(mean, kept[0]), remat.pin(var, kept[1])
        else:
            mean, var = self.running_mean, self.running_var
        a = torch.rsqrt(var + self.eps)
        if self.affine:
            a = self.weight * a
            b = self.bias - mean * a
        else:
            b = -mean * a
        return x * _per_channel(a, x).to(x.dtype) + _per_channel(b, x).to(x.dtype)


class InstanceNorm(nn.Module):
    """Affine instance norm: per-sample, per-channel statistics over the
    spatial dims (biased variance), computed in fp32."""

    def __init__(self, features, eps=1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))

    @torch.no_grad()
    def init_parameters(self, generator):
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x):
        dims = tuple(range(2, x.dim()))
        xf = x.float()
        var, mean = torch.var_mean(xf, dim=dims, keepdim=True, correction=0)
        a = _per_channel(self.weight, x) * torch.rsqrt(var + self.eps)
        b = _per_channel(self.bias, x) - mean * a
        return x * a.to(x.dtype) + b.to(x.dtype)
