"""Device idle inside the greedy loop: the time in the port's
``greedy.step`` and ``greedy.stop_check`` spans in which no device record
of the trace runs, per decoder step (the ``greedy.steps`` counter)."""

from benchmark.portspans import per, window


def read(ctx):
    w = window(ctx)
    if w is None or not w.n("greedy.step"):
        return None
    return per(w.idle_ms("greedy.step", "greedy.stop_check"),
               w.counts.get("greedy.steps"))
