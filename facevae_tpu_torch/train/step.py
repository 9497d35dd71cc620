"""One training step (port of facevae_tpu/train/step.py, with its fused-aug
mode): the generator phase (forward, backward, the generator Adam step),
then the discriminator phase on the detached generated frame and driving
keypoints (forward, backward, the discriminator Adam step).

During the generator phase the discriminator's parameters do not require
gradients (the JAX step differentiates the generator-side parameters only);
its spectral-norm u, v still advance, twice, and the discriminator phase
starts from them, as in the JAX step.

Data parallelism (``state.group`` set, the JAX step's mesh): each rank runs
the step on its own batch; after each phase's backward the gradients of
that phase's optimizer are averaged over the ranks (one all-reduce of one
flat buffer, as lax.pmean(g_grads) / pmean(d_grads)); BatchNorm averages
its statistics inside the nets; the loss scalars returned are the ranks'
mean.  The F loss stays the rank's own (its batch's), as in the JAX step.
Not DistributedDataParallel: the step calls EFE three times and the
discriminator twice a phase, toggles requires_grad between the phases, and
DDP's buffer broadcast would overwrite every rank's BatchNorm statistics
and spectral u, v from rank 0 on each forward, which the JAX step never
does.  Nothing here reads a tensor on the host, so a CUDA graph can hold
the step, collectives included (train/scan.py).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from facevae_tpu_torch import numerics
from facevae_tpu_torch.data.device_aug import augment_batch
from facevae_tpu_torch.models import D_MODEL_NAMES
from facevae_tpu_torch.ops.tps import TransformParams
from facevae_tpu_torch.train.objective import discriminator_forward, generator_forward
from facevae_tpu_torch.train.state import TrainState


def step_seed(seed: int, step: int, rank: int = 0) -> int:
    """The seed of ``step``'s draws (augmentation, TPS, VAE eps) on
    ``rank``: seed * 2^32 + step on rank 0, so that one card draws the
    stream it always drew and a resumed run draws what an uninterrupted one
    would (the JAX loop folds the step into its key); on the other ranks
    (the JAX step folds in axis_index) a 64-bit mix of (seed, step, rank)."""
    if rank == 0:
        return seed * 2 ** 32 + step
    return int(np.random.SeedSequence([seed, step, rank]).generate_state(1, np.uint64)[0])


def _set_requires_grad(state: TrainState, names, flag: bool):
    for n in names:
        state.nets[n].requires_grad_(flag)


def all_reduce_grads(opt: torch.optim.Optimizer, group) -> None:
    """Average the gradients of ``opt``'s parameters over ``group``'s ranks
    in place: one all-reduce of one flat fp32 buffer."""
    grads = [p.grad for g in opt.param_groups for p in g["params"] if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    torch._foreach_copy_(grads, [v.view_as(g) for v, g in
                                 zip(flat.split([g.numel() for g in grads]), grads)])


def _mean_losses(losses: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """The ranks' mean of each loss scalar: one all-reduce."""
    flat = torch.stack([v.detach().float() for v in losses.values()])
    dist.all_reduce(flat, group=group)
    return dict(zip(losses, (flat / dist.get_world_size(group)).unbind(0)))


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
    this step applied (with ``state.group``, the ranks' mean).  The step
    passes ``cfg.train.train_vae`` to generator_forward, as the JAX step
    does: set, the driving frame's EFE call samples its VAE (eps
    ``vae_eps``, else drawn from ``generator`` after the TPS parameters)
    and K is the KL term."""
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
    if state.group is not None:
        all_reduce_grads(state.g_opt, state.group)
    state.g_opt.step()

    _set_requires_grad(state, D_MODEL_NAMES, True)
    state.d_opt.zero_grad(set_to_none=True)
    losses_d = discriminator_forward(state.nets, state.cfg, d, aux["generated_d"].detach(),
                                     aux["kp_d"].detach())
    sum(losses_d.values()).backward()
    if state.group is not None:
        all_reduce_grads(state.d_opt, state.group)
    state.d_opt.step()
    state.step += 1
    if state.group is not None:
        mean = _mean_losses({**losses_g, **losses_d}, state.group)
        losses_g, losses_d = ({k: mean[k] for k in losses_g}, {k: mean[k] for k in losses_d})

    detach = lambda tree: {k: v.detach() for k, v in tree.items()}  # noqa: E731
    return {"losses_g": detach(losses_g), "losses_d": detach(losses_d),
            "aux": detach(aux)}
