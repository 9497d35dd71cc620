"""The median wait of a request in the collector's queue, in ms: the
program's serve.queue spans (enqueue to the start of the flush that took
the request) that end in the light slice."""
from portbench import spans


def read(ctx):
    s = ctx.slice
    if ctx.kind != "serve" or s is None or s.window_s <= 0:
        return None
    return spans.median_ms(spans.ring(s.lo, s.hi), "serve.queue", s.lo, s.hi, ends_in=True)
