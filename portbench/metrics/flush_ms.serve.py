"""The median host time of the engine's flushes in the window, images in
to frames out (BatchedEngine.flush_ms), in ms."""
import statistics


def read(ctx):
    flush_ms = ctx.facts.get("flush_ms")
    if ctx.kind != "serve" or not flush_ms:
        return None
    return statistics.median(flush_ms)
