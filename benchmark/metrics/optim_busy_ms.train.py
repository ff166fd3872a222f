"""Device time inside the optimizer: the union of the trace's device
records that fall inside the port's ``train.optimizer`` spans, per
optimizer update. In this host-bound loop a launch runs soon after the
host issues it, so the device time inside a span is the span's own work."""

from benchmark.portspans import per, window


def read(ctx):
    w = window(ctx)
    if w is None or not w.n("train.optimizer"):
        return None
    return per(w.busy_ms("train.optimizer"), ctx["work"]["updates"])
