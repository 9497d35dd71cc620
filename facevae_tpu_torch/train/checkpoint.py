"""Epoch checkpoints (port of facevae_tpu/train/checkpoint.py), in the JAX
package's own format, so that either package reads what the other wrote.

One file per epoch, ``%08d-checkpoint.msgpack``: the JAX TrainState's state
dict as flax.serialization.to_bytes writes it (train/msgpack_io.py), with
the JAX names and layouts (convert.py):

  g_params, d_params, c_params   {net: params} of the six G nets, the
                                 discriminator, the contrastive head
  teachers                       {"hopenet": variables, "perceptual": variables}
  batch_stats, spectral          {net: collection} of the trainable nets and
                                 the head
  g_opt, d_opt                   optax.adam's state, {"0": {"count", "mu",
                                 "nu"}, "1": {}}: mu / nu keyed as the params
                                 they step (g_opt covers the head's only with
                                 LossConfig.train_contrastive_head)
  epoch, step                    int32 scalars

Written by rank 0 only (or with no process group), atomically: to
``path + ".tmp"``, then os.replace, so a crash never leaves a torn epoch
file under the name that list_checkpoints matches.  load_checkpoint
restores everything into a state built for the same config, on any device,
strictly: a leaf with no counterpart, a counterpart with no leaf, or a
shape mismatch raises.
"""
from __future__ import annotations

import os
import re
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from facevae_tpu_torch.convert import (TRAIN_STATE_KEYS, adam_state_dicts,
                                       jax_tree_from_state_dict, load_jax_train_state,
                                       optax_adam_tree, weight_as_is)
from facevae_tpu_torch.models import D_MODEL_NAMES, G_MODEL_NAMES
from facevae_tpu_torch.parallel.mesh import is_master
from facevae_tpu_torch.train import msgpack_io
from facevae_tpu_torch.train.state import TrainState

_CKPT_RE = re.compile(r"^(\d{8})-checkpoint\.msgpack$")
TEACHERS = ("hopenet", "perceptual")
STATE_KEYS = TRAIN_STATE_KEYS + ("g_opt", "d_opt", "epoch", "step")


def checkpoint_path(ckp_dir: str, epoch: int, zfill_num: int = 8) -> str:
    return os.path.join(ckp_dir, f"{str(epoch).zfill(zfill_num)}-checkpoint.msgpack")


def list_checkpoints(ckp_dir: str) -> List[Tuple[int, str]]:
    """Epoch-sorted [(epoch, path)] of complete checkpoints in ckp_dir."""
    if not os.path.isdir(ckp_dir):
        return []
    out = []
    for name in os.listdir(ckp_dir):
        m = _CKPT_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(ckp_dir, name)))
    return sorted(out)


def latest_checkpoint_epoch(ckp_dir: str) -> Optional[int]:
    ckpts = list_checkpoints(ckp_dir)
    return ckpts[-1][0] if ckpts else None


def prune_checkpoints(ckp_dir: str, keep: int) -> List[str]:
    """Delete all but the ``keep`` newest epoch checkpoints (keep <= 0: keep
    all); returns the paths removed."""
    removed = []
    if keep <= 0:
        return removed
    ckpts = list_checkpoints(ckp_dir)
    for _, path in ckpts[:-keep] if len(ckpts) > keep else []:
        try:
            os.remove(path)
            removed.append(path)
        except OSError:
            pass                      # a racing reader holds it; retry next save
    return removed


def _tensors(state: TrainState) -> Dict[str, Any]:
    """What a checkpoint holds, as the state's own tensors (no copy):
    {"nets": {net: state_dict}, "as_is": {net: its ELR weights' keys},
    "g_opt" / "d_opt": adam_state_dicts(...),
    "epoch", "step"}."""
    return {"nets": {n: net.state_dict() for n, net in state.nets.items()},
            "as_is": {n: weight_as_is(net) for n, net in state.nets.items()},
            "g_opt": adam_state_dicts(state.g_opt, state.nets),
            "d_opt": adam_state_dicts(state.d_opt, state.nets),
            "epoch": int(state.epoch), "step": int(state.step)}


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_map(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _jax_tree(tensors: Dict[str, Any]) -> Dict[str, Any]:
    """_tensors' content on the host, as the JAX TrainState's state dict."""
    host = _map(lambda t: t.detach().cpu().numpy(), tensors)
    as_is = tensors["as_is"]
    var = {n: jax_tree_from_state_dict(sd, as_is[n]) for n, sd in host["nets"].items()}
    return {
        "g_params": {n: var[n]["params"] for n in G_MODEL_NAMES},
        "d_params": {n: var[n]["params"] for n in D_MODEL_NAMES},
        "c_params": {"contrastive": var["contrastive"]["params"]},
        "teachers": {n: var[n] for n in TEACHERS},
        "batch_stats": {n: v["batch_stats"] for n, v in var.items()
                        if "batch_stats" in v and n not in TEACHERS},
        "spectral": {n: v["spectral"] for n, v in var.items() if "spectral" in v},
        "g_opt": {"0": optax_adam_tree(*host["g_opt"], as_is=as_is), "1": {}},
        "d_opt": {"0": optax_adam_tree(*host["d_opt"], as_is=as_is), "1": {}},
        "epoch": np.asarray(host["epoch"], np.int32),
        "step": np.asarray(host["step"], np.int32)}


def _write(ckp_dir: str, tensors: Dict[str, Any], epoch: int, keep: int) -> str:
    os.makedirs(ckp_dir, exist_ok=True)
    path = checkpoint_path(ckp_dir, epoch)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        msgpack_io.dump(_jax_tree(tensors), f)
    os.replace(tmp, path)
    prune_checkpoints(ckp_dir, keep)
    return path


def save_checkpoint(ckp_dir: str, state: TrainState, epoch: int,
                    keep: int = 0) -> Optional[str]:
    """Write ``state`` as epoch ``epoch``'s file (rank 0 only: None
    elsewhere), then keep the ``keep`` newest epoch files (0: all)."""
    if not is_master():
        return None
    return _write(ckp_dir, _tensors(state), epoch, keep)


class AsyncCheckpointer:
    """Checkpoint saves off the training path: ``save`` copies every tensor
    of the state on its device (clone, queued on the current stream before
    any later step's in-place updates, so training may go on at once) and a
    daemon thread copies the snapshot to the host and writes the file.  One
    save in flight at a time (a second ``save`` waits for the first);
    ``wait`` flushes, and raises what the write raised."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def save(self, ckp_dir: str, state: TrainState, epoch: int, keep: int = 0) -> None:
        if not is_master():
            return
        self.wait()
        with torch.no_grad():
            snap = _map(torch.clone, _tensors(state))
        # the writer copies to the host on its own thread's stream: it waits
        # for the clones, queued on this thread's current stream, to finish
        done = None
        if any(p.is_cuda for net in state.nets.values() for p in net.parameters()):
            done = torch.cuda.Event()
            done.record()

        def write():
            try:
                if done is not None:
                    done.synchronize()
                _write(ckp_dir, snap, epoch, keep)
            except Exception as e:                # raised again by wait()
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e


def read_checkpoint(ckp_dir: str, epoch: int) -> Dict[str, Any]:
    """Epoch ``epoch``'s file as the JAX TrainState's state dict (nested
    numpy sharing one buffer of the file's bytes); its keys are checked."""
    tree = msgpack_io.load(checkpoint_path(ckp_dir, epoch))
    if not isinstance(tree, dict) or set(tree) != set(STATE_KEYS):
        got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
        raise ValueError(f"epoch {epoch} in {ckp_dir} is not a train state: keys {got}")
    return tree


def load_checkpoint(ckp_dir: str, epoch: int, state: TrainState) -> TrainState:
    """Restore epoch ``epoch``'s file into ``state`` (built for the same
    config, on any device): every net, both Adam states, epoch and step.
    Strict and shape-checked (convert.load_jax_train_state)."""
    tree = read_checkpoint(ckp_dir, epoch)
    load_jax_train_state(state.nets, tree, {"g_opt": state.g_opt, "d_opt": state.d_opt})
    state.epoch, state.step = int(tree["epoch"]), int(tree["step"])
    return state
