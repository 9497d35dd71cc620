"""Losses of the training step (port of facevae_tpu/losses): pure
functions for the stateless ones, nn.Modules for the VGG feature stacks and
the SimSiam contrastive head.  The reference's quirks stay: q3 (the stale
pyramid loop), q7 (the contrastive head is never stepped)."""
from facevae_tpu_torch.losses.gan import feature_matching_loss, gan_loss_dis, gan_loss_gen
from facevae_tpu_torch.losses.keypoint import (
    deformation_prior_loss, equivariance_loss, headpose_loss, keypoint_prior_loss,
)
from facevae_tpu_torch.losses.vae_losses import kl_divergence_loss, recon_loss
from facevae_tpu_torch.losses.vgg import VGG16_BLOCKS, VGG19_BLOCKS, VGGFeatures
from facevae_tpu_torch.losses.perceptual import PerceptualLoss
from facevae_tpu_torch.losses.contrastive import ContrastiveHead
