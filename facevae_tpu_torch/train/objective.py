"""The training objective (port of facevae_tpu/train/objective.py): the
generator-side forward with its ten losses and the discriminator's hinge
losses, fp32.

The JAX package threads BatchNorm statistics and spectral-norm u, v through
a VarBank so that repeated calls of one module see each other's updates.
Here the nets update those buffers in place as they run, so the call order
below is the update order: AFE, CKD, HPE_EDE (on source, driving and
TPS-warped driving at once), EFE three times (source with its augmented
view, driving with its augmented view, warped driving), MFE, Generator, the
discriminator twice, then the contrastive head.  The frozen Hopenet runs in
eval form without gradient.

`nets` maps the JAX package's names to modules: efe, afe, ckd, hpe_ede, mfe,
generator, discriminator, hopenet, perceptual, contrastive.  Images are
[N,H,W,3] in [0,1], channel-last.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from facevae_tpu_torch.config import Config
from facevae_tpu_torch.losses import (
    deformation_prior_loss, equivariance_loss, feature_matching_loss, gan_loss_dis,
    gan_loss_gen, headpose_loss, keypoint_prior_loss, recon_loss,
)
from facevae_tpu_torch.ops.geometry import transform_kp
from facevae_tpu_torch.ops.interpolate import interpolate_nearest_2d
from facevae_tpu_torch.ops.normalization import apply_imagenet_normalization
from facevae_tpu_torch.ops.tps import (
    TransformParams, random_transform_params, transform_frame, warp_coordinates,
)

LOSS_NAMES = ("P", "G", "F", "E", "L", "H", "D", "C", "K", "R")


def _chunk3(x):
    return x.chunk(3, dim=0)


def generator_forward(nets, cfg: Config, s, d, s_a, d_a,
                      transform_params: Optional[TransformParams] = None,
                      generator: Optional[torch.Generator] = None,
                      train_vae: bool = False
                      ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """The generator side of one step.  Returns (losses, aux): the ten
    weighted losses {P,G,F,E,L,H,D,C,K,R} and the tensors the discriminator
    phase and the visualizer read.  The TPS parameters are drawn from
    ``generator`` unless ``transform_params`` is given."""
    if cfg.model.compute_dtype != "float32":
        raise NotImplementedError("the port's training step is fp32 only; the bf16 step is "
                                  "not ported (ROADMAP Queue 1)")
    if train_vae:
        raise NotImplementedError("VAE sampling (train_vae=True) is not ported (ROADMAP "
                                  "Queue 1); the reference trains with it off (q8)")
    w = cfg.loss
    N = s.shape[0]
    fs = nets["afe"](s)
    kp_c = nets["ckd"](s)

    tp = transform_params
    if tp is None:
        t = cfg.train
        tp = random_transform_params(generator, N, sigma_affine=t.sigma_affine,
                                     sigma_tps=t.sigma_tps, points_tps=t.points_tps,
                                     device=s.device)
    transformed_d = transform_frame(tp, d)
    cated = torch.cat([s, d, transformed_d], dim=0)

    yaw, pitch, roll, t, scale = nets["hpe_ede"](cated)
    t_s, t_d, t_tran = _chunk3(t)
    scale_s, scale_d, scale_tran = _chunk3(scale)
    yaw_s, yaw_d, yaw_tran = _chunk3(yaw)
    pitch_s, pitch_d, pitch_tran = _chunk3(pitch)
    roll_s, roll_d, roll_tran = _chunk3(roll)

    # the frozen pose teacher on the nearest-resized 224x224 input
    with torch.no_grad():
        hp_in = interpolate_nearest_2d(
            apply_imagenet_normalization(cated).permute(0, 3, 1, 2), (224, 224))
        real_yaw, real_pitch, real_roll = nets["hopenet"](hp_in.permute(0, 2, 3, 1))

    kp_s_old, Rs = transform_kp(kp_c, yaw_s, pitch_s, roll_s, t_s, scale_s)
    kp_d_old, Rd = transform_kp(kp_c, yaw_d, pitch_d, roll_d, t_d, scale_d)
    transformed_kp_old, _ = transform_kp(kp_c, yaw_tran, pitch_tran, roll_tran,
                                         t_tran, scale_tran)

    efe = nets["efe"]
    kp_s, _, _, _, _ = efe(s, s_a, kp_s_old)
    kp_d, x_c_d, x_a_c_d, _, (x_vae_d, _) = efe(d, d_a, kp_d_old)
    transformed_kp = efe(transformed_d, None, transformed_kp_old)[0]

    reverse_kp = warp_coordinates(tp, transformed_kp[:, :, :2])
    deformation, occlusion, mask = nets["mfe"](fs, kp_s, kp_d, Rs, Rd)
    generated_d = nets["generator"](fs, deformation, occlusion).float()
    output_d, features_d = nets["discriminator"](d, kp_d)
    output_gd, features_gd = nets["discriminator"](generated_d, kp_d)

    zero = torch.zeros((), dtype=torch.float32, device=s.device)
    losses = {
        "P": w.perceptual * nets["perceptual"](generated_d, d),
        "G": w.gan * gan_loss_gen(output_gd),
        "F": w.feature_matching * feature_matching_loss(features_gd, features_d),
        "E": w.equivariance * equivariance_loss(kp_d, reverse_kp),
        "L": w.keypoint_prior * keypoint_prior_loss(kp_d, w.kp_prior_dt, w.kp_prior_zt),
        "H": w.headpose * headpose_loss(yaw, pitch, roll, real_yaw, real_pitch, real_roll),
        # quirk q11: the D prior penalizes EFE's deviation from pose-only kp
        "D": w.deformation_prior * deformation_prior_loss(kp_d_old - kp_d),
        "C": (w.contrastive * nets["contrastive"](x_c_d, x_a_c_d)
              if x_c_d is not None else zero),
        "K": zero,                                   # train_vae off (q8)
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
    output_d, _ = nets["discriminator"](d, kp_d.detach())
    output_gd, _ = nets["discriminator"](generated_d.detach(), kp_d.detach())
    return {"G1": cfg.loss.gan * gan_loss_dis(output_gd, t_real=False),
            "G2": cfg.loss.gan * gan_loss_dis(output_d, t_real=True)}
