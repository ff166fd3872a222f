"""Model FLOPs of the traced window's row-windows (encoder, cross-attention
k/v and decoder positions, benchmark/roofline.py) over the window's wall
time and the H100's dense bf16 peak."""

from benchmark.roofline import MFU_PEAK


def read(ctx):
    if not ctx["flops"] or ctx["wall_s"] <= 0 or ctx["trace"] is None:
        return None
    return 100.0 * ctx["flops"] / (ctx["wall_s"] * MFU_PEAK)
