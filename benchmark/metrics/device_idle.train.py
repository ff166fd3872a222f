"""Share of the traced fine-tune window in which no device record runs:
one less the union of the device activity over the window's length."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
