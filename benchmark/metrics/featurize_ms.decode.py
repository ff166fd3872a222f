"""Host featurization of a decode: the port's ``data.features`` spans (the
audio load and the log-mel), per row-window decoded."""

from benchmark.portspans import per, window


def read(ctx):
    w = window(ctx)
    if w is None or not w.n("data.features"):
        return None
    return per(w.total_ms("data.features"), ctx["work"]["row_windows"])
