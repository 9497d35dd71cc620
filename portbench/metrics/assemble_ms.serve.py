"""The median host time of a batch's assembly, in ms: the program's
serve.assemble spans (stacking the frames, the copy to the device, the
sessions' concatenation) that lie in the light slice."""
from portbench import spans


def read(ctx):
    s = ctx.slice
    if ctx.kind != "serve" or s is None or s.window_s <= 0:
        return None
    return spans.median_ms(spans.ring(s.lo, s.hi), "serve.assemble", s.lo, s.hi)
