"""The seek loop's host fetch of a decode's tokens and scores: the port's
``seek.fetch`` spans, per seek iteration (``seek.slice`` spans)."""

from benchmark.portspans import per, window


def read(ctx):
    w = window(ctx)
    if w is None or not w.n("seek.fetch"):
        return None
    return per(w.total_ms("seek.fetch"), w.n("seek.slice"))
