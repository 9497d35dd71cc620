"""Seeded weights for every net of a cell, made on the device in a few
large draws and handed to both sides (the program's nets and the plain
reference) by load_state_dict.

The leaves are read off the reference's modules, which have four kinds of
layer (portbench/reference/nn/layers.py): Conv and Dense weights and biases
draw U(-1/sqrt(fan_in), 1/sqrt(fan_in)), all from one uniform draw; a
spectral-norm Conv's u and v are unit directions from one normal draw,
then 20 power iterations of its weight, so that sigma estimates the
spectral norm; BatchNorm and InstanceNorm start at scale 1, shift 0, and
running statistics 0 and 1.  A layer of another kind is refused.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench import seeds
from portbench.reference.nn.layers import BatchNorm, Conv, Dense, InstanceNorm

POWER_ITERATIONS = 20


def _owned(module: nn.Module):
    return list(module.named_parameters(recurse=False)) + list(module.named_buffers(recurse=False))


@torch.no_grad()
def make(nets: Dict[str, nn.Module], seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """{net: state dict} of fp32 tensors on ``device`` for ``nets`` (the
    reference's modules, on any device: only their leaves' names, shapes
    and layer kinds are read)."""
    out = {name: {} for name in nets}
    uniform, spectral, constant = [], [], []
    for net, root in nets.items():
        for prefix, m in root.named_modules():
            owned = _owned(m)
            if not owned:
                continue
            key = (prefix + ".") if prefix else ""
            if isinstance(m, (Conv, Dense)):
                fan_in = m.fan_in if isinstance(m, Conv) else m.in_features
                for leaf, t in owned:
                    if leaf in ("weight", "bias"):
                        uniform.append((net, key + leaf, t.shape, 1.0 / math.sqrt(fan_in)))
                    else:
                        spectral.append((net, key + leaf, t.shape, m))
            elif isinstance(m, (BatchNorm, InstanceNorm)):
                for leaf, t in owned:
                    constant.append((net, key + leaf, t.shape,
                                     1.0 if leaf in ("weight", "running_var") else 0.0))
            else:
                raise TypeError(f"no seeded init for {type(m).__name__} ({net}.{prefix})")
    g = torch.Generator(device=device).manual_seed(seeds.sub_seed(seed, seeds.WEIGHTS))
    sizes = [math.prod(s) for _, _, s, _ in uniform]
    flat = torch.rand(sum(sizes), generator=g, device=device).mul_(2).sub_(1)
    views = [v.view(s) for v, (_, _, s, _) in zip(flat.split(sizes), uniform)]
    torch._foreach_mul_(views, [b for *_, b in uniform])
    for v, (net, name, _, _) in zip(views, uniform):
        out[net][name] = v
    sizes = [math.prod(s) for _, _, s, _ in spectral]
    if sizes:
        flat = torch.randn(sum(sizes), generator=g, device=device)
        views = list(flat.split(sizes))
        torch._foreach_div_(views, [n + 1e-12 for n in torch._foreach_norm(views)])
        for v, (net, name, _, _) in zip(views, spectral):
            out[net][name] = v
        for net, name, _, m in spectral:
            if name.endswith("weight_u"):
                base = name[: -len("weight_u")]
                w = out[net][base + "weight"].flatten(1)
                u, v = out[net][base + "weight_u"], out[net][base + "weight_v"]
                for _ in range(POWER_ITERATIONS):
                    v.copy_(F.normalize(w.t() @ u, dim=0))
                    u.copy_(F.normalize(w @ v, dim=0))
    for net, name, shape, value in constant:
        out[net][name] = torch.full(shape, value, device=device)
    return out


def load(nets: Dict[str, nn.Module], values: Dict[str, Dict[str, torch.Tensor]]) -> None:
    """Copy ``values`` into ``nets`` (strict: every leaf, no other)."""
    for name, m in nets.items():
        m.load_state_dict(values[name], strict=True)
