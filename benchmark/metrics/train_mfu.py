"""Model FLOPs of the traced window's updates (the trained encoder and CTC
head forward and backward, the frozen decoder forward and its activation
gradients, benchmark/roofline.py) over the window's wall time and the
H100's dense bf16 peak."""

from benchmark.roofline import MFU_PEAK


def read(ctx):
    if not ctx["flops"] or ctx["wall_s"] <= 0 or ctx["trace"] is None:
        return None
    return 100.0 * ctx["flops"] / (ctx["wall_s"] * MFU_PEAK)
