"""Model FLOP utilization in the serve cells: the reference's operations a
unit (torch.utils.flop_counter, forward and backward, no recomputation) x
the units of the window outside the profiled slice / that time / the
configuration dtype's peak."""
from portbench import readers


def read(ctx):
    return readers.mfu(ctx, "serve")
