"""Remat's share of the training step's device time, in the heavy slice
(one step profiled with its host operations): the device time of the
operations launched inside the outermost remat.recompute.<net> ranges (the
program's spans of each region's replay in the backward) over the device
time of all the step's operations, in %."""
from portbench import spans


def read(ctx):
    if ctx.kind != "train" or ctx.slice is None:
        return None
    return spans.share_under(ctx.slice.functions, "remat.recompute.")
