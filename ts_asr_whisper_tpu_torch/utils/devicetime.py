"""Device time of a thunk from ``torch.profiler``: the metric that host
noise does not reach.

Counterpart of ts_asr_whisper_tpu/utils/devicetime.py, which sums the
device lane of a JAX profiler trace. Here the CUDA kernel events of a
``torch.profiler`` run are summed: the microseconds the card spent in the
thunk's kernels, with the host's launch and wait time left out. The aten
rows of ``key_averages()`` repeat their kernels' time, so only rows whose
device type is CUDA count.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def measure_device_ms(thunk: Callable[[], None]) -> Optional[float]:
    """Run ``thunk`` under ``torch.profiler`` and return the summed time of
    its CUDA kernels in milliseconds, or None when no kernel was traced
    (no CUDA device, or a thunk that launched nothing). The thunk's work is
    waited for before the trace stops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        return None
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        thunk()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return us / 1e3 if us > 0 else None
