"""The greedy decode loop's span over its decoder steps."""


def read(ctx):
    n = ctx["work"]["decoder_steps"]
    t = ctx["rec"].total_s("decode_loop")
    return 1e3 * t / n if n and t > 0 else None
