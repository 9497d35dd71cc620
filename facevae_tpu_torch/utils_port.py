"""The reference's own PyTorch state dicts -> the port's nets, by structural
order (counterpart of facevae_tpu/utils_port.py).

The reference (Luh1124/face-vae) saves each net's torch ``state_dict``; its
modules are built in the same order as the JAX package's flax modules and
the port's torch modules.  So a typed zip of two streams maps one onto the
other without per-layer tables: the reference's modules in its state dict's
insertion order (torch_param_stream, copied from the JAX package without
its skip_modules option, which no converter passes), and the port net's
modules that own parameters or buffers, in registration order
(port_module_stream: the order of ``net.state_dict()``).  For every net of
ModelConfig() that order is the JAX package's creation order, which the
JAX tool zips against (tests/test_torch_utils_port.py holds it to a
committed record of that order).

The reference and the port share torch's layouts, so nothing is transposed:

  conv / linear  weight, or weight_orig where spectral norm wraps it
                 (OIHW / OIDHW / (out, in))             -> weight
                 bias                                   -> bias
  spectral norm  weight_u [O]                           -> weight_u
                 weight_v [I * prod(K)], (I, K...)      -> weight_v, as it is
  BatchNorm / InstanceNorm  weight, bias, running_mean, running_var -> the same
  ELR (and WN / UB) layers  weight, bias                -> the same, as they are

The JAX package transposes each of these into flax's layouts (HWIO kernels,
v in the (K..., I) flattening) and convert.py transposes back, so the two
routes give the same bits.  port_reference_state_dict is as strict as the
JAX function at its default (strict=True), and has no other mode: it
raises ValueError when the torch modules run out or are left over, on a
shape mismatch at any leaf, and on a module it cannot handle; values are
cast to the port parameter's dtype.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

from facevae_tpu_torch.convert import weight_as_is


def torch_param_stream(state_dict) -> List[Tuple[str, Dict[str, np.ndarray]]]:
    """Group a torch state_dict (insertion-ordered) by owning module."""
    groups: Dict[str, Dict[str, np.ndarray]] = {}
    order: List[str] = []
    for key, val in state_dict.items():
        if key.endswith("num_batches_tracked"):
            continue
        mod, leaf = key.rsplit(".", 1) if "." in key else ("", key)
        if mod not in groups:
            groups[mod] = {}
            order.append(mod)
        groups[mod][leaf] = np.asarray(val)
    return [(m, groups[m]) for m in order]


def port_module_stream(net: nn.Module) -> List[Tuple[str, Dict[str, torch.Tensor]]]:
    """The modules of ``net`` that own parameters or (persistent) buffers, in
    registration order, each with its {leaf name: tensor}."""
    groups: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, val in net.state_dict().items():
        mod, leaf = key.rsplit(".", 1) if "." in key else ("", key)
        groups.setdefault(mod, {})[leaf] = val
    return list(groups.items())


def _key(mod: str, leaf: str) -> str:
    return f"{mod}.{leaf}" if mod else leaf


def _put(out: Dict[str, torch.Tensor], own: Mapping[str, torch.Tensor], mod: str,
         leaf: str, value: np.ndarray) -> None:
    """out[mod.leaf] = value, checked against the port's shape and cast to
    its dtype (the JAX package's _set_leaf)."""
    key = _key(mod, leaf)
    expect = own[key]
    if tuple(expect.shape) != tuple(value.shape):
        raise ValueError(f"shape mismatch at {key}: {tuple(expect.shape)} vs {value.shape}")
    out[key] = torch.from_numpy(np.ascontiguousarray(value)).to(device=expect.device,
                                                               dtype=expect.dtype)


def _port_module(mod, leaves, as_is, tname, tleaves, own, out):
    """One port module from one reference module (the JAX package's
    _port_module, on torch's layouts)."""
    w = leaves.get("weight")
    has_kernel = w is not None and w.dim() >= 2 and _key(mod, "weight") not in as_is
    if has_kernel:
        # spectral-normed reference convs store weight_orig (+u/v buffers)
        tw = tleaves.get("weight", tleaves.get("weight_orig"))
        if tw is None:
            raise ValueError(f"port {mod} (conv/dense) vs torch {tname} {list(tleaves)}")
        _put(out, own, mod, "weight", tw)
        if "bias" in leaves:
            if "bias" not in tleaves:
                raise ValueError(f"{mod}: port bias but torch {tname} has none")
            _put(out, own, mod, "bias", tleaves["bias"])
    elif w is not None and _key(mod, "weight") in as_is:     # the ELR / WN / UB layers
        _put(out, own, mod, "weight", tleaves["weight"])
        if "bias" in leaves and "bias" in tleaves:
            _put(out, own, mod, "bias", tleaves["bias"])
    elif w is not None or "running_mean" in leaves:          # a norm layer
        if "weight" in tleaves and w is not None:
            _put(out, own, mod, "weight", tleaves["weight"])
        if "bias" in tleaves and "bias" in leaves:
            _put(out, own, mod, "bias", tleaves["bias"])
        if "running_mean" in tleaves and "running_mean" in leaves:
            _put(out, own, mod, "running_mean", tleaves["running_mean"])
            _put(out, own, mod, "running_var", tleaves["running_var"])
    else:
        raise ValueError(f"unhandled port module {mod}: {list(leaves)}")


def _port_spectral(mod, leaves, tleaves, own, out):
    """The reference's spectral-norm power-iteration state into a port conv
    that has it: u [O] as it is; v [I * prod(K)] as it is, since both keep
    torch's (I, K...) flattening (the JAX package permutes it to (K..., I))."""
    if "weight_u" not in leaves:
        return                          # this module isn't spectral-normed here
    _put(out, own, mod, "weight_u", tleaves["weight_u"])
    v, w = tleaves.get("weight_v"), tleaves.get("weight_orig")
    if v is not None and "weight_v" in leaves and w is not None:
        _put(out, own, mod, "weight_v", v.reshape(-1))


def port_reference_state_dict(state_dict, net: nn.Module) -> Dict[str, torch.Tensor]:
    """``net``'s state dict with the reference ``state_dict`` (a torch
    state dict, or {key: numpy array}) ported in, zipping typed module
    streams in construction order; load it with ``net.load_state_dict``.
    Leaves the reference does not have (spectral u, v of a conv it did not
    normalize) keep ``net``'s values."""
    own = net.state_dict()
    out = {k: v.detach().clone() for k, v in own.items()}
    as_is = weight_as_is(net)
    port_mods = port_module_stream(net)
    torch_mods = torch_param_stream(state_dict)

    # typed streams: each port module consumes the next torch module
    ti = 0
    for mod, leaves in port_mods:
        if ti >= len(torch_mods):
            raise ValueError(f"ran out of torch modules at {mod}")
        tname, tleaves = torch_mods[ti]
        ti += 1
        _port_module(mod, leaves, as_is, tname, tleaves, own, out)
        if "weight_u" in tleaves:
            _port_spectral(mod, leaves, tleaves, own, out)
    if ti != len(torch_mods):
        raise ValueError(f"{len(torch_mods) - ti} torch modules left unported: "
                         f"{[m for m, _ in torch_mods[ti:ti + 4]]}...")
    return out
