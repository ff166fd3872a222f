"""The encoder's span (the card synchronised at its edges in the traced
run), per row-window decoded."""


def read(ctx):
    n = ctx["work"]["row_windows"]
    t = ctx["rec"].total_s("encoder")
    return 1e3 * t / n if n and t > 0 else None
