"""The optimizer's host time: the span around the trainer's ``tx.step``
(the card is not synchronised at its edges, so the span holds the host's
launches and any wait for a full launch queue), per optimizer update."""


def read(ctx):
    n = ctx["work"]["updates"]
    t = ctx["rec"].total_s("optimizer")
    return 1e3 * t / n if n and t > 0 else None
