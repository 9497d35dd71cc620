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

On the card both optimizers are capturable (their step counts live on the
card), so a CUDA graph can hold the whole step (train/scan.py).  With a
process group (``group``) every rank holds the same state: the step
averages gradients over the ranks and BatchNorm its statistics
(parallel/mesh.py).

A state built here holds seeded random weights, teachers included: enough
for a benchmark.  With LossConfig.pretrained_dir set, the teachers found
there (vgg19.npz, vggface.npz, hopenet.npz: the JAX package's files) replace
the seeded ones, as in the JAX package (losses/pretrained.py).  A parity run
loads the JAX package's whole train state, teachers included, with
convert.load_jax_train_state; train/checkpoint.py reads and writes the JAX
package's epoch files.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from facevae_tpu_torch.config import Config
from facevae_tpu_torch.losses import ContrastiveHead, PerceptualLoss
from facevae_tpu_torch.losses.pretrained import load_pretrained
from facevae_tpu_torch.models import D_MODEL_NAMES, G_MODEL_NAMES, Hopenet, build_models
from facevae_tpu_torch.nn import init_parameters
from facevae_tpu_torch.parallel.mesh import sync_batchnorm


@dataclasses.dataclass
class TrainState:
    cfg: Config
    nets: Dict[str, nn.Module]      # the 7 trainable nets, the teachers, the head
    g_opt: torch.optim.Adam
    d_opt: torch.optim.Adam
    step: int = 0
    epoch: int = 0                  # as the JAX state's; train/checkpoint.py keeps it
    group: Optional[Any] = None     # the data-parallel process group, or None


def contrastive_in_dim(cfg: Config) -> int:
    """The contrastive head's input width, the JAX state's formula
    (facevae_tpu/train/state.py): conv5's flattened encoder map,
    (image / 64)^2 x channels, whatever the EFE variant."""
    m = cfg.model
    return (m.image_size // 64) ** 2 * m.efe_down_seq[-1]


def check_trainable(cfg: Config, efe: nn.Module) -> None:
    """Refuse an EFE whose contrastive features x_c the head cannot take:
    the JAX step fails on the head's parameter shapes there, so of the
    variants at ModelConfig() widths only conv5 and linear (which has no
    x_c) train."""
    width = getattr(efe, "x_c_dim", None)
    if width is not None and width != contrastive_in_dim(cfg):
        raise ValueError(
            f"EFE variant {cfg.model.efe_variant!r} gives contrastive features x_c of width "
            f"{width}, while the contrastive head takes {contrastive_in_dim(cfg)} "
            "((image_size / 64)^2 x efe_down_seq[-1], as the JAX state builds it): the JAX "
            "step cannot train this configuration and neither does the port")


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
    # capturable: the step count on the card, where a CUDA graph can advance
    # it (torch offers it on the card only)
    capturable = g_params[0].is_cuda
    kw = dict(lr=t.lr, betas=(t.adam_b1, t.adam_b2), eps=1e-8, capturable=capturable)
    return torch.optim.Adam(g_params, **kw), torch.optim.Adam(d_params, **kw)


def create_train_state(cfg: Config, device=None,
                       nets: Optional[Dict[str, nn.Module]] = None,
                       group=None) -> TrainState:
    """A train state on ``device`` (default: the card), over ``nets`` or
    freshly seeded ones, with the teachers of ``cfg.loss.pretrained_dir``
    loaded into them when it is set.  The trainable nets and the head are
    put in training mode; Hopenet stays in eval form.  ``group`` (a
    torch.distributed process group) makes the state data-parallel: its
    BatchNorm layers synchronize over it and train_step averages over it.
    An EFE variant the JAX step cannot train raises ValueError
    (check_trainable)."""
    device = torch.device("cuda" if device is None else device)
    nets = nets if nets is not None else build_all_modules(cfg, device)
    check_trainable(cfg, nets.get("efe"))
    if cfg.loss.pretrained_dir:
        load_pretrained(nets, cfg.loss.pretrained_dir)
    for m in nets.values():
        m.train()
    sync_batchnorm(nets, group)
    g_opt, d_opt = make_optimizers(cfg, nets)
    return TrainState(cfg=cfg, nets=nets, g_opt=g_opt, d_opt=d_opt, group=group)
