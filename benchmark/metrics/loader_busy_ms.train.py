"""The loader's work: the port's ``loader.batch`` spans in its worker
threads (featurization, augmentation, collation), summed over the threads,
per optimizer update."""

from benchmark.portspans import per, window


def read(ctx):
    w = window(ctx)
    if w is None or not w.n("loader.batch"):
        return None
    return per(w.total_ms("loader.batch"), ctx["work"]["updates"])
