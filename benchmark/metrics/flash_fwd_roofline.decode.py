"""Encoder flash attention forward: the least time its launches could take
(benchmark/roofline.py, from each launch's shapes) over the device time of
the kernel's records (``attn_fwd_*``). Where the trace caught fewer records
than launches, the bound is scaled to the records caught."""

from benchmark.devicetime import kernel_seconds


def read(ctx):
    bounds, tr = ctx["flash_fwd_bounds"], ctx["trace"]
    if not bounds or tr is None:
        return None
    records = [r for r in tr["records"] if "attn_fwd" in r[0]]
    t = kernel_seconds(records, "attn_fwd")
    if not records or t <= 0:
        return None
    bound = sum(bounds) * min(1.0, len(records) / len(bounds))
    return 100.0 * bound / t
