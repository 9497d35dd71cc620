"""The 95th percentile of the client-side latency of all /drive requests
sent in the window, a failed one counting as missing (infinite), in ms.
At this cell's closed loop the server runs at its capacity, where the tail
swings from run to run (PERF.md §2), so it stands here and not among the
end-to-end metrics."""


def read(ctx):
    if ctx.kind != "serve":
        return None
    return ctx.facts.get("p95_ms")
