"""Model zoo (port of facevae_tpu/models): AFE, CKD, HPE_EDE, the EFE
variants (the conv family with its VAEs, conv6, the linear pair), MFE,
Generator, the Discriminator and the frozen Hopenet teacher.  Images enter as
[N,H,W,3] float32 in [0,1]; every module keeps its JAX counterpart's
channel-last layouts at its boundary and runs NC(D)HW inside."""
from facevae_tpu_torch.models.afe import AFE
from facevae_tpu_torch.models.ckd import CKD
from facevae_tpu_torch.models.hpe_ede import HPE_EDE
from facevae_tpu_torch.models.vae import FlattenVAE, FlattenVAE6, FlattenVAE_NL, LocalVAE
from facevae_tpu_torch.models.embedder import get_embedder
from facevae_tpu_torch.models.efe import EFEConv
from facevae_tpu_torch.models.efe_conv6 import EFEConv6
from facevae_tpu_torch.models.efe_linear import EFELinear, efe_lin_conv_defaults
from facevae_tpu_torch.models.mfe import MFE
from facevae_tpu_torch.models.generator import Generator
from facevae_tpu_torch.models.discriminator import Discriminator
from facevae_tpu_torch.models.hopenet import Hopenet
from facevae_tpu_torch.models.factory import (D_MODEL_NAMES, EFE_VARIANTS, G_MODEL_NAMES,
                                              build_models)
