"""The warp kernels' share of their roofline in the serve cells: the sites'
bounds (warp_sites/<config>.serve.json) over the kernels' device time in the
profiled slice."""
from portbench import readers


def read(ctx):
    return readers.warp_roofline(ctx, "serve")
