"""Log-mel computations per decode batch: the port's ``data.mel_calls``
counter over its ``data.eval_batch`` spans."""

from benchmark.portspans import per, window


def read(ctx):
    w = window(ctx)
    if w is None or not w.counts.get("data.mel_calls"):
        return None
    return per(w.counts["data.mel_calls"], w.n("data.eval_batch"))
