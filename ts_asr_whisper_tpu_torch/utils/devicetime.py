"""Device time of a function from ``torch.profiler``: the metric that host
noise does not reach.

Counterpart of ts_asr_whisper_tpu/utils/devicetime.py, which sums the
device lane of a JAX profiler trace. Here the CUDA activity records of a
``torch.profiler`` trace (kernels, copies, sets) are summed: the
microseconds the card spent in the function's work, with the host's launch
and wait time left out.

A trace can lose the device records of its first launches while their
host records are there. On an NVIDIA H100 (PyTorch 2.11, CUDA 12.8) the
count lost grows with the age of the process, with or without work in
between, until a short trace keeps no device record at all (PERF.md §7),
and a sum of what it caught reads low by as much. So each trace starts
with ``lead`` launches of a one-element kernel that absorb the loss, only
the launches after them are summed, and the trace counts only when the
first of those (matched to their device records by CUPTI's correlation
id) have their device records; else it is taken again with a lead four
times as long.
"""

from __future__ import annotations

import re
import time
from typing import Callable, Optional

import torch

# host API records that put work on the card: kernel and graph launches,
# copies and sets. A kernel or graph launch always has device records; a
# copy or set of no bytes, or a host function, has none
_WORK_API = re.compile(r"Launch|Memcpy|Memset")
_LAUNCH_API = re.compile(r"Launch(?!HostFunc)")
# a trace loses the device records of its first launches: it is whole when
# the first FIRST launches of the summed calls have theirs
FIRST = 64


def kernel_trace(fn: Callable[[], object], reps: int = 1,
                 lead: int = 0) -> dict:
    """Launch a one-element kernel ``lead`` times, then call ``fn``
    ``reps`` times, under ``torch.profiler`` (CUDA activity only), wait for
    the card, and return what the trace caught of the ``reps`` calls:
    ``{"us": summed device time, "kernels": {name: [records, us, records
    of zero duration]}, "launches": host records of work put on the card,
    "unmatched": kernel or graph launches among them without a device
    record, "unmatched_first": the same among the first FIRST of them,
    "lost_in_lead": the same among the lead's, "streams": CUDA stream ids,
    "devices":
    device indices, "profiler_was_on": whether a profiler was already
    running in this process}``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    was_on = torch._C._autograd._profiler_enabled()
    one = torch.zeros(1, device="cuda") if lead else None
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(lead):
            one.add_(1.0)
        if lead:
            # the lead's launches a millisecond before the split, the
            # measured ones a millisecond after, on the profiler's clock
            torch.cuda.synchronize()
            time.sleep(1e-3)
        split = time.time_ns()
        if lead:
            time.sleep(1e-3)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    device = {}
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            device.setdefault(e.correlation_id(), []).append(e)
    work = [e for e in events if e.device_type() != DeviceType.CUDA
            and _WORK_API.search(e.name())]
    measured = [e for e in work if e.start_ns() >= split]
    kernels, streams, devices = {}, set(), set()
    total_ns = 0
    for launch in measured:
        for e in device.get(launch.correlation_id(), ()):
            ns = e.duration_ns()
            row = kernels.setdefault(e.name(), [0, 0.0, 0])
            row[0] += 1
            row[1] += ns / 1e3
            row[2] += ns == 0
            total_ns += ns
            streams.add(e.device_resource_id())
            devices.add(e.device_index())
    launches = [e for e in measured if _LAUNCH_API.search(e.name())]
    return {"us": total_ns / 1e3, "kernels": kernels,
            "launches": len(measured),
            "unmatched": sum(e.correlation_id() not in device
                             for e in launches),
            "unmatched_first": sum(e.correlation_id() not in device
                                   for e in launches[:FIRST]),
            "lost_in_lead": sum(e.correlation_id() not in device
                                and bool(_LAUNCH_API.search(e.name()))
                                for e in work if e.start_ns() < split),
            "streams": sorted(streams), "devices": sorted(devices),
            "profiler_was_on": was_on}


def measure_device_ms(fn: Callable[[], object], reps: int = 20,
                      warmup: int = 1, tries: int = 4,
                      lead: int = 256) -> Optional[float]:
    """Device time per call of ``fn`` in milliseconds: ``warmup`` calls
    first, then one trace of ``lead`` absorbing launches and ``reps``
    calls, summed over the calls and divided by ``reps``. A trace in which
    one of the calls' first FIRST launches has no device record, or that
    caught no work, is taken again with a lead four times as long, up to
    ``tries`` traces in all.
    None without a CUDA device, or when no trace was whole (a device time
    is never replaced by a host time)."""
    if not torch.cuda.is_available():
        return None
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        trace = kernel_trace(fn, reps, lead)
        if trace["us"] > 0 and not trace["unmatched_first"]:
            return trace["us"] / 1e3 / reps
        lead *= 4
    return None
