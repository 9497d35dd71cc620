"""The port's train state (counterpart of facevae_tpu/train/state.py).

It holds the seven trainable nets, the frozen teachers (Hopenet, the VGG19
and VGG-Face stacks of the perceptual loss), the SimSiam contrastive head and
two Adam optimizers: one over the six generator-side nets and one over the
discriminator (lr 5e-5, betas (0.5, 0.999), eps 1e-8: the update of
optax.adam).  Adam has no coupling between parameters, so one optimizer over
six nets makes the same updates as the reference's six.

Quirk q7: the contrastive head's parameters are frozen (its BatchNorm
statistics still train) unless LossConfig.train_contrastive_head is set,
which adds them to the generator optimizer.

A state built here holds seeded random weights, teachers included: enough
for a benchmark.  A parity run loads the JAX package's whole train state,
teachers included, with convert.load_jax_train_state.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn as nn

from facevae_tpu_torch.config import Config
from facevae_tpu_torch.losses import ContrastiveHead, PerceptualLoss
from facevae_tpu_torch.models import D_MODEL_NAMES, G_MODEL_NAMES, Hopenet, build_models
from facevae_tpu_torch.nn import init_parameters


@dataclasses.dataclass
class TrainState:
    cfg: Config
    nets: Dict[str, nn.Module]      # the 7 trainable nets, the teachers, the head
    g_opt: torch.optim.Adam
    d_opt: torch.optim.Adam
    step: int = 0


def contrastive_in_dim(cfg: Config) -> int:
    """Flattened size of EFE's encoder map: (image / 64)^2 x channels."""
    m = cfg.model
    return (m.image_size // 64) ** 2 * m.efe_down_seq[-1]


def build_all_modules(cfg: Config, device) -> Dict[str, nn.Module]:
    """The nets of one step, seeded from 0 on ``device``: the 7 trainable
    nets in build_models' order, then the teachers and the head."""
    g = torch.Generator(device=device).manual_seed(0)
    nets = build_models(cfg.model, device=device, generator=g,
                        names=G_MODEL_NAMES + D_MODEL_NAMES)
    nets["hopenet"] = init_parameters(Hopenet(device=device), g)
    nets["perceptual"] = init_parameters(
        PerceptualLoss(cfg.loss.n_scales, cfg.loss.fixed_pyramid, device=device), g)
    nets["contrastive"] = init_parameters(
        ContrastiveHead(contrastive_in_dim(cfg), device=device), g)
    return nets


def make_optimizers(cfg: Config, nets):
    t = cfg.train
    g_params = [p for n in G_MODEL_NAMES for p in nets[n].parameters()]
    head = list(nets["contrastive"].parameters())
    if cfg.loss.train_contrastive_head:
        g_params += head
    for p in head:
        p.requires_grad_(cfg.loss.train_contrastive_head)
    d_params = [p for n in D_MODEL_NAMES for p in nets[n].parameters()]
    kw = dict(lr=t.lr, betas=(t.adam_b1, t.adam_b2), eps=1e-8)
    return torch.optim.Adam(g_params, **kw), torch.optim.Adam(d_params, **kw)


def create_train_state(cfg: Config, device=None,
                       nets: Optional[Dict[str, nn.Module]] = None) -> TrainState:
    """A train state on ``device`` (default: the card), over ``nets`` or
    freshly seeded ones.  The trainable nets and the head are put in
    training mode; Hopenet stays in eval form."""
    device = torch.device("cuda" if device is None else device)
    nets = nets if nets is not None else build_all_modules(cfg, device)
    for m in nets.values():
        m.train()
    g_opt, d_opt = make_optimizers(cfg, nets)
    return TrainState(cfg=cfg, nets=nets, g_opt=g_opt, d_opt=d_opt)
