"""Neural building blocks (port of facevae_tpu/nn): layers.py (Conv, Dense,
BatchNorm, InstanceNorm; eval and training forms), blocks.py (CNA conv blocks), init.py
(seeded init)."""
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
