from portbench.reference.nn.init import init_parameters
from portbench.reference.nn.layers import BatchNorm, Conv, Dense, InstanceNorm
from portbench.reference.nn.blocks import (
    ConvBlock,
    DownBlock2D, DownBlock3D,
    UpBlock2D, UpBlock3D,
    SameBlock2D, SameBlock3D,
    ResBlock2D, ResBlock3D,
    ResBottleneck,
    named_sequence,
)
