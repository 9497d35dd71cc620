"""The reference's train state: the 7 trainable nets, the frozen teachers
(Hopenet, the VGG19 and VGG-Face stacks of the perceptual loss), the
SimSiam contrastive head (frozen, quirk q7) and two Adam optimizers (lr
5e-5, betas (0.5, 0.999), eps 1e-8: the update of optax.adam), one over
the six generator-side nets and one over the discriminator.  The modules
are built unseeded: portbench/weights.py fills them."""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn as nn

from portbench.reference.config import Config
from portbench.reference.losses import ContrastiveHead, PerceptualLoss
from portbench.reference.models import D_MODEL_NAMES, G_MODEL_NAMES, Hopenet, build_models


@dataclasses.dataclass
class TrainState:
    cfg: Config
    nets: Dict[str, nn.Module]
    g_opt: torch.optim.Adam
    d_opt: torch.optim.Adam
    step: int = 0


def contrastive_in_dim(cfg: Config) -> int:
    m = cfg.model
    return (m.image_size // 64) ** 2 * m.efe_down_seq[-1]


def build_all_modules(cfg: Config, device) -> Dict[str, nn.Module]:
    """The nets of one step, unfilled, in the program's order: the 7
    trainable nets, then the teachers and the head."""
    nets = build_models(cfg.model, device=device, names=G_MODEL_NAMES + D_MODEL_NAMES)
    nets["hopenet"] = Hopenet(device=device)
    nets["perceptual"] = PerceptualLoss(cfg.loss.n_scales, cfg.loss.fixed_pyramid,
                                        device=device)
    nets["contrastive"] = ContrastiveHead(contrastive_in_dim(cfg), device=device)
    return nets


def create_train_state(cfg: Config, nets: Dict[str, nn.Module]) -> TrainState:
    """Training mode for every net, the head frozen, plain Adam."""
    for m in nets.values():
        m.train()
    t = cfg.train
    g_params = [p for n in G_MODEL_NAMES for p in nets[n].parameters()]
    head = list(nets["contrastive"].parameters())
    if cfg.loss.train_contrastive_head:
        g_params += head
    for p in head:
        p.requires_grad_(cfg.loss.train_contrastive_head)
    d_params = [p for n in D_MODEL_NAMES for p in nets[n].parameters()]
    kw = dict(lr=t.lr, betas=(t.adam_b1, t.adam_b2), eps=1e-8)
    return TrainState(cfg=cfg, nets=nets, g_opt=torch.optim.Adam(g_params, **kw),
                      d_opt=torch.optim.Adam(d_params, **kw))
