"""The gradient norm of ``train_step``: the port's ``train.grad_norm`` spans
(``global_norm`` over every leaf, and the per-module norms under
``watch_grads``), per optimizer update."""

from benchmark.portspans import per, window


def read(ctx):
    w = window(ctx)
    if w is None or not w.n("train.grad_norm"):
        return None
    return per(w.total_ms("train.grad_norm"), ctx["work"]["updates"])
