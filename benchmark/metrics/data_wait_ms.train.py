"""Host data of a fine-tune: the time ``Trainer.train_step`` waits for its
micro-batch from the port's ``DataLoader`` (the span around its
``next()``), per optimizer update."""


def read(ctx):
    n = ctx["work"]["updates"]
    t = ctx["rec"].total_s("data_wait")
    return 1e3 * t / n if n and t > 0 else None
