"""The share of the engine's batches dispatched behind another, in %: of
the program's serve.graph spans that start in the light slice, those that
start while an earlier batch's serve.flush span is open.  A collector that
answers each batch before it takes the next reads 0."""
from portbench import spans


def read(ctx):
    s = ctx.slice
    if ctx.kind != "serve" or s is None or s.window_s <= 0:
        return None
    ring = spans.ring(s.lo, s.hi) or ()
    lo, hi = int(s.lo * 1e9), int(s.hi * 1e9)
    graphs = [x for x in ring if x.name == "serve.graph" and lo <= x.start_ns <= hi]
    if not graphs:
        return None
    flushes = [x for x in ring if x.name == "serve.flush"]
    behind = sum(any(f.id != g.parent and f.start_ns < g.start_ns < f.end_ns for f in flushes)
                 for g in graphs)
    return 100.0 * behind / len(graphs)
