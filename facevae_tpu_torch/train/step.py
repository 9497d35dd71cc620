"""One training step on one device (port of facevae_tpu/train/step.py,
mesh=None): the generator phase (forward, backward, the generator Adam
step), then the discriminator phase on the detached generated frame and
driving keypoints (forward, backward, the discriminator Adam step).

During the generator phase the discriminator's parameters do not require
gradients (the JAX step differentiates the generator-side parameters only);
its spectral-norm u, v still advance, twice, and the discriminator phase
starts from them, as in the JAX step.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from facevae_tpu_torch import numerics
from facevae_tpu_torch.models import D_MODEL_NAMES
from facevae_tpu_torch.ops.tps import TransformParams
from facevae_tpu_torch.train.objective import discriminator_forward, generator_forward
from facevae_tpu_torch.train.state import TrainState


def _set_requires_grad(state: TrainState, names, flag: bool):
    for n in names:
        state.nets[n].requires_grad_(flag)


def train_step(state: TrainState, batch, transform_params: Optional[TransformParams] = None,
               generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
    """batch = (s, d, s_a, d_a), each [N,H,W,3] float32 on the state's
    device.  Updates ``state`` in place and returns {"losses_g": {...},
    "losses_d": {...}, "aux": {...}} (tensors on the device, detached).
    After the call every trainable parameter's .grad holds the gradient
    this step applied."""
    numerics.apply()
    s, d, s_a, d_a = batch

    _set_requires_grad(state, D_MODEL_NAMES, False)
    state.g_opt.zero_grad(set_to_none=True)
    losses_g, aux = generator_forward(state.nets, state.cfg, s, d, s_a, d_a,
                                      transform_params=transform_params,
                                      generator=generator)
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
