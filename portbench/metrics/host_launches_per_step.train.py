"""CUDA runtime and driver calls that launch device work (launch_calls.json)
per training step, in the profiled slice: a count."""
from portbench import readers


def read(ctx):
    return readers.launches_per_unit(ctx, "train")
