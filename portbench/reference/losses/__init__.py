from portbench.reference.losses.gan import feature_matching_loss, gan_loss_dis, gan_loss_gen
from portbench.reference.losses.keypoint import (
    deformation_prior_loss, equivariance_loss, headpose_loss, keypoint_prior_loss,
)
from portbench.reference.losses.vae_losses import kl_divergence_loss, recon_loss
from portbench.reference.losses.perceptual import PerceptualLoss
from portbench.reference.losses.contrastive import ContrastiveHead
