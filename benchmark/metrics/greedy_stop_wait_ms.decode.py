"""The greedy step's one host sync: the port's ``greedy.stop_check`` spans
(the wait for the step's device work left when its last launch returns),
per decoder step (the ``greedy.steps`` counter)."""

from benchmark.portspans import per, window


def read(ctx):
    w = window(ctx)
    if w is None or not w.n("greedy.stop_check"):
        return None
    return per(w.total_ms("greedy.stop_check"), w.counts.get("greedy.steps"))
