"""The seek loop's preparation: the port's ``seek.upload`` (the
recordings' upload, once a batch) and ``seek.slice`` spans (compaction,
the windows, the row gathers), per seek iteration (``seek.slice`` spans)."""

from benchmark.portspans import per, window


def read(ctx):
    w = window(ctx)
    if w is None:
        return None
    return per(w.total_ms("seek.upload", "seek.slice"), w.n("seek.slice"))
