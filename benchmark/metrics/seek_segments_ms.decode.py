"""The seek loop's segment retrieval: the port's ``seek.segments`` spans
(the no-speech skip, the fallback checks, token timestamps and
``retrieve_segment``), per seek iteration (``seek.slice`` spans)."""

from benchmark.portspans import per, window


def read(ctx):
    w = window(ctx)
    if w is None or not w.n("seek.segments"):
        return None
    return per(w.total_ms("seek.segments"), w.n("seek.slice"))
