"""Weight bridge: JAX (flax) variables -> the port's state_dicts.

load_jax_variables takes one net's variables as nested dicts of numpy arrays,
{"params": ..., "batch_stats": ..., "spectral": ...}.  The port's modules
carry the flax names (nn/blocks.py), so the mapping is keyed on names, never
on dict order (jit round trips alphabetize keys):

  params/<path>/kernel  HWIO / DHWIO / (in,out) -> <path>.weight OIHW / OIDHW / (out,in)
  params/<path>/bias                            -> <path>.bias
  params/<path>/scale   (BatchNorm, InstanceNorm)-> <path>.weight
  batch_stats/<path>/mean, var                  -> <path>.running_mean, .running_var
  spectral/<path>/u                             -> <path>.weight_u
  spectral/<path>/v     (K..., I) flattening     -> <path>.weight_v in (I, K...) order

It is strict: a leaf with no counterpart, a parameter with no leaf, or a shape
mismatch raises ValueError.

load_jax_train_state carries a whole JAX train state across (g_params,
d_params, c_params, teachers, batch_stats, spectral), net by net through
load_jax_variables.  The teachers (Hopenet, the perceptual loss's VGG stacks)
come this way: the port never draws teacher weights of its own for parity.

A JAX leaf or collection with no name in the map raises UnmappedLeaf, both a
ValueError and a KeyError (the teacher files of losses/pretrained.py raise
KeyError for a key with no leaf, as the JAX package does).
"""
from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch


def natural_key(s: str):
    """Sort key under which Conv_10 follows Conv_9."""
    return [int(p) if p.isdigit() else p for p in re.split(r"(\d+)", s)]


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator:
    for k in sorted(tree, key=natural_key):
        v = tree[k]
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def nested_from_flat(flat: Mapping[str, Any], sep: str = "/") -> Dict[str, Any]:
    """{"a/b/c": x} -> {"a": {"b": {"c": x}}} (e.g. the leaves of an .npz)."""
    out: Dict[str, Any] = {}
    for key, v in flat.items():
        node = out
        *path, leaf = key.split(sep)
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _torch_kernel(k: np.ndarray) -> np.ndarray:
    if k.ndim == 2:                                  # Dense (in, out)
        return k.T
    if k.ndim in (4, 5):                             # (*k, I, O) -> (O, I, *k)
        nd = k.ndim - 2
        return k.transpose((nd + 1, nd) + tuple(range(nd)))
    raise ValueError(f"unexpected kernel rank {k.ndim}")


class UnmappedLeaf(KeyError, ValueError):
    """A JAX leaf or variable collection that the name map does not know."""


def state_dict_from_jax(variables: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Map one net's JAX variables to a {state_dict key: numpy array} dict."""
    collections = set(variables) - {"params", "batch_stats", "spectral"}
    if collections:
        raise UnmappedLeaf(f"unknown variable collections {sorted(collections)}")
    out: Dict[str, np.ndarray] = {}
    kernels: Dict[Tuple[str, ...], np.ndarray] = {}

    def put(path, name, value):
        key = ".".join(path + (name,))
        if key in out:
            raise ValueError(f"two JAX leaves map to {key}")
        out[key] = np.ascontiguousarray(value)

    leaf_names = {"params": {"kernel": "weight", "bias": "bias", "scale": "weight"},
                  "batch_stats": {"mean": "running_mean", "var": "running_var"},
                  "spectral": {"u": "weight_u", "v": "weight_v"}}
    for col in ("params", "batch_stats", "spectral"):
        for path, a in _leaves(variables.get(col, {})):
            mod, leaf = path[:-1], path[-1]
            if leaf not in leaf_names[col]:
                raise UnmappedLeaf(f"unmapped JAX leaf {col}/{'/'.join(path)}")
            if col == "params" and leaf == "kernel":
                kernels[mod] = a
                a = _torch_kernel(a)
            elif col == "spectral" and leaf == "v":
                if mod not in kernels:
                    raise ValueError(f"spectral v at {'/'.join(mod)} has no kernel")
                k = kernels[mod]
                nd = k.ndim - 2                       # v is (*k, I) flattened
                a = (a.reshape(k.shape[:-1])
                     .transpose((nd,) + tuple(range(nd))).reshape(-1))
            put(mod, leaf_names[col][leaf], a)
    return out


def load_jax_variables(model: torch.nn.Module, variables: Mapping[str, Any]):
    """Copy one net's JAX variables into ``model`` (on its device), strictly."""
    new = state_dict_from_jax(variables)
    own = model.state_dict()
    missing = sorted(set(own) - set(new), key=natural_key)
    extra = sorted(set(new) - set(own), key=natural_key)
    if missing or extra:
        raise ValueError(f"{type(model).__name__}: parameters with no JAX leaf "
                         f"{missing}; JAX leaves with no parameter {extra}")
    for k, v in new.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"{type(model).__name__}.{k}: JAX shape {v.shape} vs "
                             f"port shape {tuple(own[k].shape)}")
    model.load_state_dict({k: torch.from_numpy(v).to(own[k].dtype)
                           for k, v in new.items()}, strict=True)
    return model


TRAIN_STATE_KEYS = ("g_params", "d_params", "c_params", "teachers", "batch_stats", "spectral")


def load_jax_train_state(nets: Mapping[str, torch.nn.Module], tree: Mapping[str, Any]):
    """Copy a JAX TrainState's variables (``tree``: a mapping with
    TRAIN_STATE_KEYS, nested numpy) into the port's ``nets`` (keyed by the
    JAX names), strictly: every net of ``nets`` must be filled, and every
    tree of ``tree`` must have a net."""
    missing = [k for k in TRAIN_STATE_KEYS if k not in tree]
    if missing:
        raise ValueError(f"train state lacks {missing}")
    params = {**tree["g_params"], **tree["d_params"], **tree["c_params"]}
    teachers = dict(tree["teachers"])
    stray = (set(tree["batch_stats"]) | set(tree["spectral"])) - set(params)
    unknown = (set(params) | set(teachers)) - set(nets)
    unfilled = set(nets) - set(params) - set(teachers)
    if stray or unknown or unfilled:
        raise ValueError(f"train state and nets differ: state trees with no params {sorted(stray)}, "
                         f"nets the port lacks {sorted(unknown)}, "
                         f"port nets with no state {sorted(unfilled)}")
    for name, p in params.items():
        variables = {"params": p}
        for col in ("batch_stats", "spectral"):
            if name in tree[col]:
                variables[col] = tree[col][name]
        load_jax_variables(nets[name], variables)
    for name, variables in teachers.items():
        load_jax_variables(nets[name], variables)
    return nets
