"""Contrastive losses on EFE's encoder features (port of
facevae_tpu/losses/contrastive.py).

ContrastiveHead, the SimSiam head of the training step (mode
"non-direction"): a 3-layer projector (Linear-BN-ReLU x2, Linear + BN
without affine) and a 2-layer predictor; loss = 1 - (cos(p1, sg(z2)) +
cos(p2, sg(z1))) / 2.  Quirk q7: the reference trains the head's BatchNorm
statistics but never steps its parameters; the train state freezes them
unless LossConfig.train_contrastive_head is set.

The dormant rest, which no model path runs: contrastive_loss (mode
"direction", 1 - cos on the raw features), ContrastiveHeadConv (a 1x1
projection to 3 channels, then LPIPS) and ContrastiveHeadConv2 (a strided
conv + BatchNorm projector and the predictor).  Feature maps arrive
channel-last [N,h,w,C], as EFE hands them over.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from portbench.reference.nn import BatchNorm, Conv, Dense


def _cosine(a, b, eps=1e-8):
    a, b = a.float(), b.float()
    num = torch.sum(a * b, dim=1)
    den = torch.clamp(torch.linalg.vector_norm(a, dim=1) * torch.linalg.vector_norm(b, dim=1),
                      min=eps)
    return num / den


class _Projector(nn.Module):
    def __init__(self, in_dim, hid_dim, out_dim, device=None):
        super().__init__()
        self.proj_fc1 = Dense(in_dim, hid_dim, bias=False, device=device)
        self.proj_bn1 = BatchNorm(hid_dim, device=device)
        self.proj_fc2 = Dense(hid_dim, hid_dim, bias=False, device=device)
        self.proj_bn2 = BatchNorm(hid_dim, device=device)
        self.proj_fc3 = Dense(hid_dim, out_dim, device=device)
        self.proj_bn3 = BatchNorm(out_dim, affine=False, device=device)

    def forward(self, x):
        x = torch.relu(self.proj_bn1(self.proj_fc1(x)))
        x = torch.relu(self.proj_bn2(self.proj_fc2(x)))
        return self.proj_bn3(self.proj_fc3(x))


class _Predictor(nn.Module):
    def __init__(self, in_dim, hid_dim, out_dim, device=None):
        super().__init__()
        self.pred_fc1 = Dense(in_dim, hid_dim, bias=False, device=device)
        self.pred_bn1 = BatchNorm(hid_dim, device=device)
        self.pred_fc2 = Dense(hid_dim, out_dim, device=device)

    def forward(self, x):
        return self.pred_fc2(torch.relu(self.pred_bn1(self.pred_fc1(x))))


class ContrastiveHead(nn.Module):
    """loss(f1, f2) on two views' features; f1, f2 are flattened in the
    order they arrive: EFE hands them channel-last [N,h,w,C], as the JAX
    module's are, so the flatten order (h, w, C) matches its Dense kernels."""

    def __init__(self, in_dim, hid_dim=512, out_dim=512, device=None):
        super().__init__()
        self.projection = _Projector(in_dim, hid_dim, out_dim, device=device)
        self.predictor = _Predictor(out_dim, hid_dim, out_dim, device=device)

    def forward(self, f1, f2):
        z1 = self.projection(f1.reshape(f1.shape[0], -1))
        z2 = self.projection(f2.reshape(f2.shape[0], -1))
        p1 = self.predictor(z1)
        p2 = self.predictor(z2)
        return 1.0 - (_cosine(p1, z2.detach()).mean() + _cosine(p2, z1.detach()).mean()) * 0.5


def contrastive_loss(f1, f2):
    """Mode "direction" (losses.py:277): 1 - cos(f1, f2) on the flattened
    raw features, averaged over the batch."""
    return 1.0 - _cosine(f1.reshape(f1.shape[0], -1), f2.reshape(f2.shape[0], -1)).mean()


def _nchw(f):
    return f.permute(0, 3, 1, 2)


class ContrastiveHeadConv(nn.Module):
    """The reference's ContrastiveLoss_conv (losses.py:281-326) in its
    default mode "direction": a 1x1 conv projects both [N,h,w,in_dim] maps
    to 3 channels, and the loss is the mean LPIPS distance between the two
    projections.  forward(f1, f2, lpips) takes the frozen LPIPS module
    (losses/lpips.py) apart, as the JAX head takes its variables: the head's
    own parameters are the projection's alone.  Its mode "non-direction" is
    broken upstream (the JAX module's docstring says how) and is not built."""

    def __init__(self, in_dim, device=None):
        super().__init__()
        self.projection = Conv(in_dim, 3, 1, 1, 0, device=device)

    def forward(self, f1, f2, lpips):
        z1 = self.projection(_nchw(f1)).permute(0, 2, 3, 1)
        z2 = self.projection(_nchw(f2)).permute(0, 2, 3, 1)
        return lpips(z1, z2).mean()


class ContrastiveHeadConv2(nn.Module):
    """The reference's ContrastiveLoss_conv2 (losses.py:329-382), mode
    "non-direction": a stride-2 3x3 conv and BatchNorm without affine
    project each [N,h,w,in_dim] map, flattened in (C, h, w) order as the
    reference's z.view(N, -1) does (the predictor's weights expect it; it
    shows only above 1x1); the predictor (dim_linear wide, its input
    out_dim * ceil(h/2) * ceil(w/2) = dim_linear) and the symmetric negative
    cosine follow.  Training and eval forms by the module's mode."""

    def __init__(self, in_dim=256, out_dim=128, dim_linear=512, device=None):
        super().__init__()
        self.proj_conv = Conv(in_dim, out_dim, 3, 2, 1, device=device)
        self.proj_bn = BatchNorm(out_dim, affine=False, device=device)
        self.predictor = _Predictor(dim_linear, dim_linear, dim_linear, device=device)

    def _project(self, f):
        z = self.proj_bn(self.proj_conv(_nchw(f)))
        return z.reshape(z.shape[0], -1)

    def forward(self, f1, f2):
        z1, z2 = self._project(f1), self._project(f2)
        p1, p2 = self.predictor(z1), self.predictor(z2)
        return 1.0 - (_cosine(p1, z2.detach()).mean() + _cosine(p2, z1.detach()).mean()) * 0.5
