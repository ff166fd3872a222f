"""Host data of a decode window: the featurisation and collation of each
batch (the span around the port's ``eval_batches`` step), per row-window
decoded."""


def read(ctx):
    n = ctx["work"]["row_windows"]
    t = ctx["rec"].total_s("host_data")
    return 1e3 * t / n if n and t > 0 else None
