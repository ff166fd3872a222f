"""The backward's host time: the port's ``train.backward`` spans
(``.backward()`` and, under tensor parallelism, the gradient sync), per
optimizer update."""

from benchmark.portspans import per, window


def read(ctx):
    w = window(ctx)
    if w is None or not w.n("train.backward"):
        return None
    return per(w.total_ms("train.backward"), ctx["work"]["updates"])
