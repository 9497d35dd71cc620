"""One training step of the reference: the generator phase (forward,
backward, the generator Adam step), then the discriminator phase on the
detached generated frame and driving keypoints, as the program's fused-aug
step: the contrastive views are made from ``generator`` (s's draws, then
d's), then the TPS parameters are drawn from it."""
from __future__ import annotations

from typing import Any, Dict

import torch

from portbench.reference.aug import augment_batch
from portbench.reference.models import D_MODEL_NAMES
from portbench.reference.objective import discriminator_forward, generator_forward


def _set_requires_grad(state, names, flag: bool):
    for n in names:
        state.nets[n].requires_grad_(flag)


def train_step(state, batch, generator: torch.Generator) -> Dict[str, Any]:
    """batch = (s, d), uint8 [N,H,W,3] (scaled by 1/255) or float in [0,1].
    Updates ``state`` in place; returns the step's losses and each
    trainable parameter's gradient as the optimizers got it."""
    s, d = batch
    if s.dtype == torch.uint8:
        s, d = s.float() / 255.0, d.float() / 255.0
    with torch.no_grad():
        s_a = augment_batch(generator, s, state.cfg.data)
        d_a = augment_batch(generator, d, state.cfg.data)

    _set_requires_grad(state, D_MODEL_NAMES, False)
    state.g_opt.zero_grad(set_to_none=True)
    losses_g, aux = generator_forward(state.nets, state.cfg, s, d, s_a, d_a,
                                      generator=generator, train_vae=state.cfg.train.train_vae)
    sum(losses_g.values()).backward()
    state.g_opt.step()

    _set_requires_grad(state, D_MODEL_NAMES, True)
    state.d_opt.zero_grad(set_to_none=True)
    losses_d = discriminator_forward(state.nets, state.cfg, d, aux["generated_d"].detach(),
                                     aux["kp_d"].detach())
    sum(losses_d.values()).backward()
    state.d_opt.step()
    state.step += 1
    return {"losses_g": {k: v.detach() for k, v in losses_g.items()},
            "losses_d": {k: v.detach() for k, v in losses_d.items()}}
