"""Load the pretrained teachers' weights (counterpart of
facevae_tpu/losses/pretrained.py) from the npz files the JAX package reads:
``vgg19.npz`` and ``vggface.npz`` (the perceptual loss's stacks) and
``hopenet.npz``, each flat and keyed by '/'-joined flax paths (as
tools/convert_torch_weights.py writes them), mapped onto the port's modules
by convert.state_dict_from_jax.

As in the JAX package: a file may hold a subset of its teacher's leaves (the
others keep their values); a key with no leaf raises KeyError, a shape
mismatch ValueError, and then no teacher changes (every file is checked
before any is copied); a teacher whose file is missing keeps its seeded
weights, and when no file exists a warning says so.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch
import torch.nn as nn

from facevae_tpu_torch.convert import nested_from_flat, state_dict_from_jax

# file -> (net, the flax path of the file's keys in the net's variables)
TEACHER_FILES = (("vgg19.npz", "perceptual", "params/vgg19/"),
                 ("vggface.npz", "perceptual", "params/vggface/"),
                 ("hopenet.npz", "hopenet", ""))


def _checked(model: nn.Module, path: str, prefix: str) -> Dict[str, np.ndarray]:
    """The file at ``path`` as {state_dict key of ``model``: array}."""
    with np.load(path) as data:
        new = state_dict_from_jax(nested_from_flat({prefix + k: data[k] for k in data.files}))
    own = model.state_dict()
    for k, a in new.items():
        if k not in own:
            raise KeyError(f"{path}: no target for {k}")
        if tuple(a.shape) != tuple(own[k].shape):
            raise ValueError(f"shape mismatch at {k}: {tuple(own[k].shape)} vs {a.shape}")
    return new


def load_pretrained(nets: Dict[str, nn.Module], pretrained_dir: str) -> Dict[str, nn.Module]:
    """Copy the teacher files found in ``pretrained_dir`` into
    nets["perceptual"] and nets["hopenet"], in place."""
    loaded, updates = [], []
    for fname, net, prefix in TEACHER_FILES:
        path = os.path.join(pretrained_dir, fname)
        if os.path.exists(path):
            updates.append((nets[net], _checked(nets[net], path, prefix)))
            loaded.append(fname[:-len(".npz")])
    with torch.no_grad():
        for model, new in updates:
            own = model.state_dict()
            for k, a in new.items():
                own[k].copy_(torch.from_numpy(a).to(own[k].dtype))
    if loaded:
        print(f"loaded pretrained teachers: {', '.join(loaded)}")
    else:
        print(f"WARNING: no pretrained artifacts in {pretrained_dir}; "
              "teachers stay random-init")
    return nets
