"""Neural building blocks (port of facevae_tpu/nn): layers.py (Conv, Dense,
BatchNorm, InstanceNorm; eval and training forms), blocks.py (CNA conv blocks), elr.py
(the equalized-learning-rate layers of the dormant EFE variants), wn.py (the
weight-normalized and untied-bias layers), init.py (seeded init)."""
from facevae_tpu_torch.nn.init import init_parameters
from facevae_tpu_torch.nn.layers import BatchNorm, Conv, Dense, InstanceNorm
from facevae_tpu_torch.nn.blocks import (
    ConvBlock,
    DownBlock2D, DownBlock3D,
    UpBlock2D, UpBlock3D,
    SameBlock2D, SameBlock3D,
    ResBlock2D, ResBlock3D,
    ResBottleneck,
    named_sequence,
)
from facevae_tpu_torch.nn.elr import (
    Conv2dELR,
    ConvTranspose1dELR, ConvTranspose2dELR, ConvTranspose3dELR,
    LinearELR,
    UpSampleBlock3d,
)
from facevae_tpu_torch.nn.wn import (
    Conv2dUB, Conv2dWN, Conv2dWNUB,
    ConvTranspose2dUB, ConvTranspose2dWN, ConvTranspose2dWNUB,
    Conv3dUB, ConvTranspose3dUB,
    LinearWN,
    dilate2d, downsample2d, fuse_wn,
)
