"""The training objective (port of facevae_tpu/train/objective.py): the
generator-side forward with its ten losses and the discriminator's hinge
losses.

Mixed precision follows the JAX objective: with
ModelConfig.compute_dtype="bfloat16" the images enter every net in bf16 and
the conv stacks run in bf16, while parameters, BatchNorm statistics,
geometry (keypoints, rotations, warp coordinates, softmax heatmaps) and
every loss reduction stay fp32.  The TPS-warped driving frame and the
generated frame are fp32 between nets and cast back where they enter one.

The JAX package threads BatchNorm statistics and spectral-norm u, v through
a VarBank so that repeated calls of one module see each other's updates.
Here the nets update those buffers in place as they run, so the call order
below is the update order: AFE, CKD, HPE_EDE (on source, driving and
TPS-warped driving at once), EFE three times (source with its augmented
view, driving with its augmented view, warped driving), MFE, Generator, the
discriminator twice, then the contrastive head.  The frozen Hopenet runs in
eval form without gradient.

With ModelConfig.remat (the default, as in the JAX package) the nets the
JAX objective wraps in jax.checkpoint are rematerialized at the same call
boundaries (facevae_tpu_torch/remat.py): CKD, HPE_EDE, the three EFE
calls, MFE, the Generator, the discriminator's calls of both phases and
the perceptual loss; AFE, the frozen Hopenet and the contrastive head are
not.  The warps' outputs are kept, not recomputed; a recompute advances no
BatchNorm statistics or spectral u, v, and the driving EFE call's eps is
drawn once, in the forward, from the step's generator.  A remat step
computes the same values as a step without it.

Each net's call is a ``net.<name>`` span (facevae_tpu_torch/tracing.py;
``net.tps`` the TPS draw and warp of the driving frame), and a remat
region takes the net's name (``remat.recompute.<name>``).

`nets` maps the JAX package's names to modules: efe, afe, ckd, hpe_ede, mfe,
generator, discriminator, hopenet, perceptual, contrastive.  Images are
[N,H,W,3] in [0,1], channel-last.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from facevae_tpu_torch import remat, tracing
from facevae_tpu_torch.config import Config
from facevae_tpu_torch.losses import (
    deformation_prior_loss, equivariance_loss, feature_matching_loss, gan_loss_dis,
    gan_loss_gen, headpose_loss, keypoint_prior_loss, kl_divergence_loss, recon_loss,
)
from facevae_tpu_torch.ops.geometry import transform_kp
from facevae_tpu_torch.ops.interpolate import interpolate_nearest_2d
from facevae_tpu_torch.ops.normalization import apply_imagenet_normalization
from facevae_tpu_torch.ops.tps import (
    TransformParams, random_transform_params, transform_frame, warp_coordinates,
)

LOSS_NAMES = ("P", "G", "F", "E", "L", "H", "D", "C", "K", "R")
_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _chunk3(x):
    return x.chunk(3, dim=0)


def _net(name: str, rm: bool, fn, *args, **kwargs):
    """fn(*args, **kwargs), rematerialized with ``rm``, in a ``net.<name>``
    span."""
    with tracing.span("net." + name):
        return remat.call(rm, fn, *args, name=name, **kwargs)


def compute_dtype(cfg: Config) -> torch.dtype:
    """The dtype the conv stacks run in: ModelConfig.compute_dtype."""
    name = cfg.model.compute_dtype
    if name not in _COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {name!r} is not one of {sorted(_COMPUTE_DTYPES)}")
    return _COMPUTE_DTYPES[name]


def generator_forward(nets, cfg: Config, s, d, s_a, d_a,
                      transform_params: Optional[TransformParams] = None,
                      generator: Optional[torch.Generator] = None,
                      train_vae: bool = False, vae_eps: Optional[torch.Tensor] = None
                      ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """The generator side of one step.  Returns (losses, aux): the ten
    weighted losses {P,G,F,E,L,H,D,C,K,R} and the tensors the discriminator
    phase and the visualizer read.  The TPS parameters are drawn from
    ``generator`` unless ``transform_params`` is given.  With train_vae the
    driving frame's EFE call samples its VAE (the other two do not) and K is
    the weighted KL term; its eps is ``vae_eps`` or drawn from ``generator``
    after the TPS parameters, the order of the JAX objective's key split."""
    w = cfg.loss
    N = s.shape[0]
    cdt = compute_dtype(cfg)
    s_c, d_c = s.to(cdt), d.to(cdt)
    s_a = s_a.to(cdt) if s_a is not None else None
    d_a = d_a.to(cdt) if d_a is not None else None
    rm = cfg.model.remat
    fs = _net("afe", False, nets["afe"], s_c)
    kp_c = _net("ckd", rm, nets["ckd"], s_c)

    with tracing.span("net.tps"):
        tp = transform_params
        if tp is None:
            t = cfg.train
            tp = random_transform_params(generator, N, sigma_affine=t.sigma_affine,
                                         sigma_tps=t.sigma_tps, points_tps=t.points_tps,
                                         device=s.device)
        transformed_d = transform_frame(tp, d.float(), compute_dtype=cdt).float()
    cated = torch.cat([s_c, d_c, transformed_d.to(cdt)], dim=0)

    yaw, pitch, roll, t, scale = _net("hpe_ede", rm, nets["hpe_ede"], cated)
    t_s, t_d, t_tran = _chunk3(t)
    scale_s, scale_d, scale_tran = _chunk3(scale)
    yaw_s, yaw_d, yaw_tran = _chunk3(yaw)
    pitch_s, pitch_d, pitch_tran = _chunk3(pitch)
    roll_s, roll_d, roll_tran = _chunk3(roll)

    # the frozen pose teacher on the nearest-resized 224x224 input
    with torch.no_grad(), tracing.span("net.hopenet"):
        hp_in = interpolate_nearest_2d(
            apply_imagenet_normalization(cated).permute(0, 3, 1, 2), (224, 224))
        real_yaw, real_pitch, real_roll = nets["hopenet"](hp_in.permute(0, 2, 3, 1))

    kp_s_old, Rs = transform_kp(kp_c, yaw_s, pitch_s, roll_s, t_s, scale_s)
    kp_d_old, Rd = transform_kp(kp_c, yaw_d, pitch_d, roll_d, t_d, scale_d)
    transformed_kp_old, _ = transform_kp(kp_c, yaw_tran, pitch_tran, roll_tran,
                                         t_tran, scale_tran)

    efe = nets["efe"]
    kp_s, _, _, _, _ = _net("efe", rm, efe, s_c, s_a, kp_s_old)
    kp_d, x_c_d, x_a_c_d, (mu_d, logstd_d), (x_vae_d, _) = _net(
        "efe", rm, efe, d_c, d_a, kp_d_old, train_vae=train_vae, eps=vae_eps,
        generator=generator)
    transformed_kp = _net("efe", rm, efe, transformed_d.to(cdt), None, transformed_kp_old)[0]

    reverse_kp = warp_coordinates(tp, transformed_kp[:, :, :2])
    deformation, occlusion, mask = _net("mfe", rm, nets["mfe"], fs, kp_s, kp_d, Rs, Rd)
    generated_d = _net("generator", rm, nets["generator"], fs, deformation, occlusion).float()
    output_d, features_d = _net("discriminator", rm, nets["discriminator"], d_c, kp_d)
    output_gd, features_gd = _net("discriminator", rm, nets["discriminator"],
                                  generated_d.to(cdt), kp_d)

    zero = torch.zeros((), dtype=torch.float32, device=s.device)
    losses = {
        "P": w.perceptual * _net("perceptual", rm, nets["perceptual"], generated_d.to(cdt), d_c),
        "G": w.gan * gan_loss_gen(output_gd),
        "F": w.feature_matching * feature_matching_loss(features_gd, features_d),
        "E": w.equivariance * equivariance_loss(kp_d, reverse_kp),
        "L": w.keypoint_prior * keypoint_prior_loss(kp_d, w.kp_prior_dt, w.kp_prior_zt),
        "H": w.headpose * headpose_loss(yaw, pitch, roll, real_yaw, real_pitch, real_roll),
        # quirk q11: the D prior penalizes EFE's deviation from pose-only kp
        "D": w.deformation_prior * deformation_prior_loss(kp_d_old - kp_d),
        "C": (w.contrastive * _net("contrastive", False, nets["contrastive"], x_c_d, x_a_c_d)
              if x_c_d is not None else zero),
        "K": (w.kl * kl_divergence_loss(mu_d, logstd_d)
              if train_vae and mu_d is not None else zero),
        "R": w.recon * recon_loss(d, generated_d) if x_vae_d is not None else zero,
    }
    aux = {
        "generated_d": generated_d,
        "transformed_d": transformed_d,
        "kp_s": kp_s,
        "kp_d": kp_d,
        "transformed_kp": transformed_kp,
        "occlusion": occlusion.float(),
        "mask": mask.sum(dim=1),
    }
    return losses, aux


def discriminator_forward(nets, cfg: Config, d, generated_d, kp_d) -> Dict[str, torch.Tensor]:
    """The discriminator's hinge losses on real d and the detached fake."""
    cdt, rm = compute_dtype(cfg), cfg.model.remat
    output_d, _ = _net("discriminator", rm, nets["discriminator"], d.to(cdt), kp_d.detach())
    output_gd, _ = _net("discriminator", rm, nets["discriminator"],
                        generated_d.detach().to(cdt), kp_d.detach())
    return {"G1": cfg.loss.gan * gan_loss_dis(output_gd, t_real=False),
            "G2": cfg.loss.gan * gan_loss_dis(output_d, t_real=True)}
