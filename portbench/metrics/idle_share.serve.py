"""The device's idle share of the profiled slice: 1 - (union of device
operation intervals) / slice length, in the serve cells."""
from portbench import readers


def read(ctx):
    return readers.idle_share(ctx, "serve")
