"""The plain reference's side of a training cell's check: the first
``check_steps`` steps from the seed's weights, frames and generator states,
and the readings that portbench/checks.py compares.

``precision`` "fp32" is the reference (TF32 off); "tf32" is its control,
TF32 on for cuDNN and cuBLAS, the nearest precision below fp32.  ``fault``
"half_batch" plants a fault in the reference put in the program's place:
the step trains on the first half of each batch, the mean over the rest.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from portbench import checks, frames, seeds, weights
from portbench.reference import config as rc
from portbench.reference import state as rs
from portbench.reference.models import D_MODEL_NAMES, G_MODEL_NAMES
from portbench.reference.step import train_step

G_TERMS = ("P", "G", "F", "E", "L", "H", "D", "C", "K", "R")
D_TERMS = ("G1", "G2")
TRAINED = G_MODEL_NAMES + D_MODEL_NAMES
# nets whose buffers a training step moves (the head's BatchNorm trains, q7)
STATEFUL = TRAINED + ("contrastive",)


def reference_config(config: Dict) -> rc.Config:
    """The configuration file's model and losses, fp32 and without remat."""
    return rc.Config(model=rc.ModelConfig(**config.get("model", {}), compute_dtype="float32",
                                          remat=False),
                     loss=rc.LossConfig(**config.get("loss", {})))


def param_leaves(nets) -> List[tuple]:
    """(net, name) of every trainable parameter, G nets then D, in the
    order both sides walk them."""
    return [(n, k) for n in TRAINED for k, _ in nets[n].named_parameters()]


def buffer_leaves(nets) -> List[tuple]:
    return [(n, k) for n in STATEFUL for k, b in nets[n].named_buffers()
            if b.is_floating_point()]


def leaf_tensors(nets, leaves, kind: str) -> List[torch.Tensor]:
    """The parameters (kind "param") or buffers named by leaves = [(net, name)]."""
    trees = {n: dict(nets[n].named_parameters() if kind == "param" else nets[n].named_buffers())
             for n in {net for net, _ in leaves}}
    return [trees[net][name] for net, name in leaves]


def step_losses(out) -> List[float]:
    v = [out["losses_g"][t] for t in G_TERMS] + [out["losses_d"][t] for t in D_TERMS]
    return torch.stack([x.float() for x in v]).tolist()


def pairs(traffic: Dict, seed: int, batch: int):
    """The cell's [max_steps, batch] tables; both sides draw the whole table."""
    return frames.pair_tables(seed, traffic["max_steps"], batch, traffic["identities"],
                              traffic["clips_per_identity"], traffic["frames_per_clip"],
                              traffic["check_steps"])


def make_frames(traffic: Dict, size: int, seed: int, device) -> torch.Tensor:
    return frames.smooth_clips(traffic["identities"] * traffic["clips_per_identity"],
                               traffic["frames_per_clip"], size, seed, traffic["grain"],
                               device)


def set_precision(precision: str) -> None:
    tf32 = {"fp32": False, "tf32": True}[precision]
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32


def run(config: Dict, traffic: Dict, seed: int, device, precision: str = "fp32",
        fault: Optional[str] = None, count_flops: bool = False) -> Dict:
    """The reference's readings: {"losses": every step's, "grad": the
    first step's, "buffers": their change in the first step, "change": the
    parameters' change over the steps} and, with ``count_flops``,
    "flops_per_step" (the first step's operations, forward and backward of
    both phases, by torch.utils.flop_counter)."""
    set_precision(precision)
    cfg = reference_config(config)
    batch = config["batch_per_chip"]
    nets = rs.build_all_modules(cfg, device)
    initial = weights.make(nets, seed, device)
    weights.load(nets, initial)
    params, buffers = param_leaves(nets), buffer_leaves(nets)
    before_p = [initial[n][k] for n, k in params]
    before_b = [initial[n][k] for n, k in buffers]
    state = rs.create_train_state(cfg, nets)
    data = make_frames(traffic, cfg.model.image_size, seed, device)
    s_idx, d_idx = pairs(traffic, seed, batch)
    g = torch.Generator(device=device)
    out = {"losses": []}
    for k in range(traffic["check_steps"]):
        g.manual_seed(seeds.step_seed(seed, k))
        s = data[torch.as_tensor(s_idx[k], device=device)]
        d = data[torch.as_tensor(d_idx[k], device=device)]
        if fault == "half_batch":
            s, d = s[: batch // 2], d[: batch // 2]
        if count_flops and k == 0:
            from torch.utils.flop_counter import FlopCounterMode
            with FlopCounterMode(display=False) as counter:
                res = train_step(state, (s, d), g)
            out["flops_per_step"] = float(counter.get_total_flops())
        else:
            res = train_step(state, (s, d), g)
        out["losses"].append(step_losses(res))
        if k == 0:
            grads = [p.grad for p in leaf_tensors(nets, params, "param")]
            out["grad"] = checks.leaf_norms([torch.zeros(1, device=device) if x is None else x
                                             for x in grads])
            out["buffers"] = checks.change_norms(leaf_tensors(nets, buffers, "buffer"), before_b)
    out["change"] = checks.change_norms(leaf_tensors(nets, params, "param"), before_p)
    del state, nets, initial, data
    set_precision("fp32")
    return out
