"""Frames over batches x max_batch of the engine's flushes in the window
(BatchedEngine.stats), in %."""


def read(ctx):
    f = ctx.facts
    if ctx.kind != "serve" or not f.get("batches"):
        return None
    return 100.0 * f["frames"] / (f["batches"] * f["max_batch"])
