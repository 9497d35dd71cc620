"""Training steps in spawned ranks, for the parity tests and chip_smoke.py:
each rank runs the data-parallel step on its part of given batches and
sends back what the step left (parallel/spawn.py hands it back).

``weights`` is {net: state dict} as numpy (every net of the train state,
teachers included), or the JAX package's train-state tree as nested numpy
(convert.load_jax_train_state reads it), or a path to either written by
torch.save: every rank, and any one-process reference, starts from exactly
these tensors.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch
import torch.distributed as dist

from facevae_tpu_torch.convert import load_jax_train_state
from facevae_tpu_torch.models import D_MODEL_NAMES, G_MODEL_NAMES
from facevae_tpu_torch.ops.tps import TransformParams
from facevae_tpu_torch.parallel.mesh import SYNC_NETS, local_batch_size

TRAINED = G_MODEL_NAMES + D_MODEL_NAMES


def state_weights(nets) -> Dict[str, Dict[str, np.ndarray]]:
    """{net: state dict} of ``nets`` as numpy (what ``weights`` takes)."""
    return {n: {k: _host(v) for k, v in net.state_dict().items()} for n, net in nets.items()}


def _state(cfg, weights, device, group):
    from facevae_tpu_torch.train.state import build_all_modules, create_train_state
    if isinstance(weights, str):
        weights = torch.load(weights, weights_only=False)
    nets = build_all_modules(cfg, device)
    if "g_params" in weights:
        load_jax_train_state(nets, weights)
    else:
        with torch.no_grad():
            for n, net in nets.items():
                for k, v in net.state_dict().items():
                    v.copy_(torch.from_numpy(np.asarray(weights[n][k])))
    return create_train_state(cfg, device, nets, group=group)


def _host(t: torch.Tensor) -> np.ndarray:
    """A copy on the host (never a view of a CPU tensor the next step
    updates in place)."""
    return t.detach().cpu().numpy().copy()


def _snapshot(state) -> Dict[str, Any]:
    """The step's outputs on the host: every trained net's and the head's
    state dict, each trained parameter's gradient and Adam exp_avg (by net
    and key)."""
    nets = {n: {k: _host(v) for k, v in state.nets[n].state_dict().items()} for n in SYNC_NETS}
    grads, exp_avg = {}, {}
    for opt in (state.g_opt, state.d_opt):
        for n in TRAINED:
            for k, p in state.nets[n].named_parameters():
                if p in opt.state:
                    grads.setdefault(n, {})[k] = _host(p.grad)
                    exp_avg.setdefault(n, {})[k] = _host(opt.state[p]["exp_avg"])
    return {"nets": nets, "grads": grads, "exp_avg": exp_avg}


def run_steps(cfg, weights, steps: Sequence, device="cpu", group=None,
              snapshot_every: bool = False) -> Dict[str, Any]:
    """Train steps of a state built from ``weights`` (with ``group``: a
    rank's), one per entry of ``steps``: (images, tp), images the numpy
    (s, d, s_a, d_a), tp the numpy (theta, control points, control params).
    Returns {"losses": [{name: float}] a step, "states": the snapshot after
    each step (snapshot_every) or after the last}."""
    from facevae_tpu_torch.train.step import train_step
    state = _state(cfg, weights, device, group)
    losses, states = [], []
    for images, tp in steps:
        out = train_step(state, [torch.from_numpy(np.ascontiguousarray(b)).to(device)
                                 for b in images],
                         transform_params=TransformParams(
                             *(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                               for a in tp)))
        losses.append({k: float(v) for k, v in {**out["losses_g"], **out["losses_d"]}.items()})
        if snapshot_every:
            states.append(_snapshot(state))
    return {"losses": losses, "states": states if snapshot_every else [_snapshot(state)]}


def rank_part(steps: Sequence, rank: int, world: int) -> List:
    """This rank's part of each step: its rows of the images, of theta and
    of the control params (the control points are shared)."""
    out = []
    for images, (theta, points, params) in steps:
        n = local_batch_size(images[0].shape[0], world)
        rows = slice(rank * n, (rank + 1) * n)
        out.append((tuple(b[rows] for b in images), (theta[rows], points, params[rows])))
    return out


def rank_steps(cfg, weights, steps: Sequence, device="cpu", checks: bool = False,
               snapshot_every: bool = False, deterministic: bool = False) -> Dict[str, Any]:
    """In a spawned rank (the default group up): run_steps on this rank's
    part of ``steps`` with the default group.  With ``checks``, two
    references run while the ranks wait for each other: rank 0 runs its
    part of the first step with a group of rank 0 alone and with no group
    ("world1_same": whether the two agree bit for bit in losses, every
    trained net's parameters and buffers, gradients and Adam moments;
    "world1_diff": where not), and rank 1 runs the whole batches in one
    process ("whole": run_steps' result).  ``deterministic``: every step
    under torch.use_deterministic_algorithms(True) (on the card the warp's
    dx otherwise adds with atomics in varying order)."""
    torch.use_deterministic_algorithms(deterministic)
    rank, world = dist.get_rank(), dist.get_world_size()
    if device != "cpu":
        device = torch.device("cuda", torch.cuda.current_device())
    mine = rank_part(steps, rank, world)
    out = run_steps(cfg, weights, mine, device, dist.group.WORLD, snapshot_every)
    if checks:
        solo = dist.new_group([0])
        if rank == 0:
            a = run_steps(cfg, weights, mine[:1], device, solo)
            b = run_steps(cfg, weights, mine[:1], device, None)
            diff = bit_differences(a, b)
            out.update(world1_same=not diff, world1_diff=diff[:8])
        elif rank == 1:
            out["whole"] = run_steps(cfg, weights, steps, device, None, snapshot_every)
        dist.barrier()
    return out


def bit_differences(a, b, path="") -> List[str]:
    """Where two nested results (dicts / lists of numpy arrays and floats)
    differ bit for bit."""
    if isinstance(a, dict):
        if set(a) != set(b):
            return [f"{path}: keys differ"]
        return [d for k in a for d in bit_differences(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, (list, tuple)):
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in bit_differences(x, y, f"{path}[{i}]")]
    if isinstance(a, np.ndarray):
        same = a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
        return [] if same else [path]
    return [] if np.float64(a).tobytes() == np.float64(b).tobytes() else [path]
