"""Encoder flash attention backward: the least time its launches could take
(benchmark/roofline.py, from each launch's shapes) over the device time of
its three kernels' records (``attn_bwd_*``: the D pre-pass, the main
kernel, the dq cast). Where the trace caught fewer main-kernel records than
launches, the bound is scaled to the records caught."""

from benchmark.devicetime import kernel_seconds


def read(ctx):
    bounds, tr = ctx["flash_bwd_bounds"], ctx["trace"]
    if not bounds or tr is None:
        return None
    records = [r for r in tr["records"] if "attn_bwd" in r[0]]
    t = kernel_seconds(records, "attn_bwd")
    main = sum(1 for r in records
               if "attn_bwd_bf16_sm90" in r[0] or "attn_bwd_dkv_f32" in r[0])
    if not records or t <= 0 or not main:
        return None
    return 100.0 * sum(bounds) * min(1.0, main / len(bounds)) / t
