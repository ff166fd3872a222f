"""The seek loop's own time from the port's spans: ``decode.longform`` less
its ``seek.encoder`` and ``seek.decode`` spans, per seek iteration
(``seek.slice`` spans). It reads the region that ``seek_self_ms.decode``
reads from the benchmark's wrappers."""

from benchmark.portspans import per, window


def read(ctx):
    w = window(ctx)
    if w is None or not w.n("decode.longform"):
        return None
    own = (w.total_ms("decode.longform")
           - w.total_ms("seek.encoder", "seek.decode"))
    return per(own, w.n("seek.slice"))
