"""The convolutions' share of their roofline in the train cells: the sum of
each outermost aten::convolution* op's least time (direct operations at the
configuration dtype's peak against its bytes at 3.35 TB/s) over the device
time of the kernels they ran, in the profiled slice."""
from portbench import readers


def read(ctx):
    return readers.conv_roofline(ctx, "train")
