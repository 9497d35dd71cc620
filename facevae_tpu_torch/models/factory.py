"""Model factory (port of facevae_tpu/models/factory.py): config -> the six
generator-side nets and the discriminator, seeded, in eval mode."""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from facevae_tpu_torch.config import ModelConfig
from facevae_tpu_torch.models.afe import AFE
from facevae_tpu_torch.models.ckd import CKD
from facevae_tpu_torch.models.discriminator import Discriminator
from facevae_tpu_torch.models.efe import EFEConv
from facevae_tpu_torch.models.generator import Generator
from facevae_tpu_torch.models.hpe_ede import HPE_EDE
from facevae_tpu_torch.models.mfe import MFE
from facevae_tpu_torch.nn import init_parameters

G_MODEL_NAMES = ("efe", "afe", "ckd", "hpe_ede", "mfe", "generator")
D_MODEL_NAMES = ("discriminator",)


def build_models(cfg: ModelConfig, device=None,
                 generator: Optional[torch.Generator] = None,
                 names: Sequence[str] = G_MODEL_NAMES) -> Dict[str, nn.Module]:
    """Instantiate the named nets on ``device``, initialized from
    ``generator`` (default: seed 0 on that device) in G_MODEL_NAMES +
    D_MODEL_NAMES order, and put them in eval mode.

    Raises on EFE variants other than conv5: they are not ported yet
    (ROADMAP Queue 1)."""
    unknown = [n for n in names if n not in G_MODEL_NAMES + D_MODEL_NAMES]
    if unknown:
        raise ValueError(f"unknown nets {unknown}; the port builds "
                         f"{G_MODEL_NAMES + D_MODEL_NAMES}")
    ctor = {
        "efe": lambda: EFEConv(
            variant=cfg.efe_variant, down_seq=tuple(cfg.efe_down_seq),
            up_seq=tuple(cfg.efe_up_seq), D=cfg.depth, K=cfg.num_kp,
            n_res=cfg.efe_n_res, scale_factor=cfg.efe_scale_factor,
            use_vae=cfg.efe_use_vae, use_weight_norm=cfg.use_weight_norm, device=device),
        "afe": lambda: AFE(
            down_seq=tuple(cfg.afe_down_seq), n_res=cfg.afe_n_res, C=cfg.app_channels,
            D=cfg.depth, use_weight_norm=cfg.use_weight_norm, device=device),
        "ckd": lambda: CKD(
            down_seq=tuple(cfg.ckd_down_seq), up_seq=tuple(cfg.ckd_up_seq), D=cfg.depth,
            K=cfg.num_kp, scale_factor=cfg.ckd_scale_factor,
            use_weight_norm=cfg.use_weight_norm, device=device),
        "hpe_ede": lambda: HPE_EDE(
            n_filters=tuple(cfg.hpe_filters), n_blocks=tuple(cfg.hpe_blocks),
            n_bins=cfg.n_bins, use_weight_norm=cfg.use_weight_norm, device=device),
        "mfe": lambda: MFE(
            down_seq=tuple(cfg.mfe_down_seq), up_seq=tuple(cfg.mfe_up_seq), K=cfg.num_kp,
            D=cfg.depth, C1=cfg.app_channels, C2=cfg.mfe_compress,
            use_weight_norm=cfg.use_weight_norm, device=device),
        "generator": lambda: Generator(
            up_seq=tuple(cfg.gen_up_seq), n_res=cfg.gen_n_res, D=cfg.depth,
            C=cfg.app_channels, use_weight_norm=cfg.gen_use_weight_norm, device=device),
        "discriminator": lambda: Discriminator(
            down_seq=tuple(cfg.disc_down_seq), K=cfg.num_kp,
            use_weight_norm=cfg.disc_use_weight_norm, device=device),
    }
    if generator is None:
        generator = torch.Generator(device=device or "cpu").manual_seed(0)
    models = {}
    for name in G_MODEL_NAMES + D_MODEL_NAMES:
        if name in names:
            models[name] = init_parameters(ctor[name](), generator).eval()
    return models
