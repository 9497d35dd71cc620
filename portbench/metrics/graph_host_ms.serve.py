"""The median host time in the drive graph a batch, in ms: the program's
serve.graph spans (the call of drive_frame, which returns once its work is
queued on the device) that lie in the light slice."""
from portbench import spans


def read(ctx):
    s = ctx.slice
    if ctx.kind != "serve" or s is None or s.window_s <= 0:
        return None
    return spans.median_ms(spans.ring(s.lo, s.hi), "serve.graph", s.lo, s.hi)
