"""The device's idle time inside the engine's flushes, as a share of the
light slice, in %: the union of the program's serve.flush spans, clipped to
the slice, less the device's busy time in it, over the slice's length.
idle_share.serve less this is the idle time between flushes."""
from portbench import spans


def read(ctx):
    s = ctx.slice
    if ctx.kind != "serve" or s is None or s.window_s <= 0:
        return None
    flushes = [spans.seconds(x) for x in spans.ring(s.lo, s.hi) or () if x.name == "serve.flush"]
    if not flushes:
        return None
    device = [(a, b) for a, b, _ in s.device]
    return 100.0 * spans.idle_within(device, flushes, s.lo, s.hi) / s.window_s
