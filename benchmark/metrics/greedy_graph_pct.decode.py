"""Share of the greedy loop's steps whose decoder ran as a replayed CUDA
graph: the port's ``greedy.graph_replays`` counter over its
``greedy.steps``, in percent."""

from benchmark.portspans import per, window


def read(ctx):
    w = window(ctx)
    if w is None or not w.counts.get("greedy.graph_replays"):
        return None
    return per(100.0 * w.counts["greedy.graph_replays"],
               w.counts.get("greedy.steps"))
