"""SimSiam contrastive head on EFE's encoder features (port of
facevae_tpu/losses/contrastive.py:ContrastiveHead, mode "non-direction").

A 3-layer projector (Linear-BN-ReLU x2, Linear + BN without affine) and a
2-layer predictor; loss = 1 - (cos(p1, sg(z2)) + cos(p2, sg(z1))) / 2.
Quirk q7: the reference trains the head's BatchNorm statistics but never
steps its parameters; the train state freezes them unless
LossConfig.train_contrastive_head is set.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from facevae_tpu_torch.nn import BatchNorm, Dense


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
