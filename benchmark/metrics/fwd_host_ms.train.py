"""The forward's host time: the port's ``train.forward`` spans
(``loss_fn``: its launches, and any wait for a full launch queue), per
optimizer update."""

from benchmark.portspans import per, window


def read(ctx):
    w = window(ctx)
    if w is None or not w.n("train.forward"):
        return None
    return per(w.total_ms("train.forward"), ctx["work"]["updates"])
