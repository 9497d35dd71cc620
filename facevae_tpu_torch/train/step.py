"""One training step on one device (port of facevae_tpu/train/step.py,
mesh=None, with its fused-aug mode): the generator phase (forward,
backward, the generator Adam step), then the discriminator phase on the
detached generated frame and driving keypoints (forward, backward, the
discriminator Adam step).

During the generator phase the discriminator's parameters do not require
gradients (the JAX step differentiates the generator-side parameters only);
its spectral-norm u, v still advance, twice, and the discriminator phase
starts from them, as in the JAX step.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from facevae_tpu_torch import numerics
from facevae_tpu_torch.data.device_aug import augment_batch
from facevae_tpu_torch.models import D_MODEL_NAMES
from facevae_tpu_torch.ops.tps import TransformParams
from facevae_tpu_torch.train.objective import discriminator_forward, generator_forward
from facevae_tpu_torch.train.state import TrainState


def _set_requires_grad(state: TrainState, names, flag: bool):
    for n in names:
        state.nets[n].requires_grad_(flag)


def train_step(state: TrainState, batch, transform_params: Optional[TransformParams] = None,
               generator: Optional[torch.Generator] = None,
               vae_eps: Optional[torch.Tensor] = None, fused_aug: bool = False) -> Dict[str, Any]:
    """batch = (s, d, s_a, d_a), each [N,H,W,3] float32 on the state's
    device; with ``fused_aug``, batch = (s, d), uint8 (scaled by 1/255) or
    float, and the contrastive views s_a, d_a are made here by
    data/device_aug.augment_batch (no gradient flows into them, as JAX's
    stop_gradient), from ``generator``: s's draws, then d's, then the TPS
    parameters, then the VAE eps.  Updates ``state`` in place and returns
    {"losses_g": {...}, "losses_d": {...}, "aux": {...}} (tensors on the
    device, detached).
    After the call every trainable parameter's .grad holds the gradient
    this step applied.  The step passes ``cfg.train.train_vae`` to generator_forward, as
    the JAX step does: set, the driving frame's EFE call samples its VAE
    (eps ``vae_eps``, else drawn from ``generator`` after the TPS
    parameters) and K is the KL term."""
    numerics.apply()
    if fused_aug:
        s, d = batch
        if s.dtype == torch.uint8:
            s, d = s.float() / 255.0, d.float() / 255.0
        with torch.no_grad():
            s_a = augment_batch(generator, s, state.cfg.data)
            d_a = augment_batch(generator, d, state.cfg.data)
    else:
        s, d, s_a, d_a = batch

    _set_requires_grad(state, D_MODEL_NAMES, False)
    state.g_opt.zero_grad(set_to_none=True)
    losses_g, aux = generator_forward(state.nets, state.cfg, s, d, s_a, d_a,
                                      transform_params=transform_params,
                                      generator=generator, train_vae=state.cfg.train.train_vae,
                                      vae_eps=vae_eps)
    sum(losses_g.values()).backward()
    state.g_opt.step()

    _set_requires_grad(state, D_MODEL_NAMES, True)
    state.d_opt.zero_grad(set_to_none=True)
    losses_d = discriminator_forward(state.nets, state.cfg, d, aux["generated_d"].detach(),
                                     aux["kp_d"].detach())
    sum(losses_d.values()).backward()
    state.d_opt.step()
    state.step += 1

    detach = lambda tree: {k: v.detach() for k, v in tree.items()}  # noqa: E731
    return {"losses_g": detach(losses_g), "losses_d": detach(losses_d),
            "aux": detach(aux)}
