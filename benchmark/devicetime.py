"""Device activity of a traced window from ``torch.profiler``: the busy
time (the union of every device record), the time by kernel, and the idle
gaps.

The method of the port's ``utils/devicetime.py``, copied so that the
yardstick stays fixed when the port's copy changes: a trace can lose the
device records of its first launches, so the trace opens with ``lead``
one-element launches that absorb the loss, only what is launched after them
counts, and the trace is whole when the first ``FIRST`` kernel launches
after them have their device records (matched by CUPTI's correlation id).
Timestamps are nanoseconds on the profiler's clock, which is the host's
``time.time_ns()``.
"""

from __future__ import annotations

import re
import time
from typing import Dict, List, Tuple

_WORK_API = re.compile(r"Launch|Memcpy|Memset")
_LAUNCH_API = re.compile(r"Launch(?!HostFunc)")
FIRST = 64


class DeviceTrace:
    """``with DeviceTrace() as tr: <window>``; then ``tr.result()``."""

    def __init__(self, lead: int = 1024):
        self.lead = lead
        self.prof = None
        self.split_ns = self.end_ns = 0

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        one = torch.zeros(1, device="cuda")
        for _ in range(self.lead):
            one.add_(1.0)
        torch.cuda.synchronize()
        time.sleep(1e-3)
        self.split_ns = time.time_ns()
        time.sleep(1e-3)
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        self.end_ns = time.time_ns()
        self.prof.__exit__(*exc)
        return False

    def result(self) -> dict:
        """``{"records": [(name, start_ns, end_ns)] of the device work
        launched after the lead, "busy_s", "window_s", "by_name": {name:
        seconds}, "unmatched_first": kernel launches among the first FIRST
        without a device record}``."""
        from torch.autograd import DeviceType

        events = list(self.prof.profiler.kineto_results.events())
        device: Dict[int, list] = {}
        for e in events:
            if e.device_type() == DeviceType.CUDA:
                device.setdefault(e.correlation_id(), []).append(e)
        work = sorted((e for e in events
                       if e.device_type() != DeviceType.CUDA
                       and _WORK_API.search(e.name())
                       and e.start_ns() >= self.split_ns),
                      key=lambda e: e.start_ns())
        records: List[Tuple[str, int, int]] = []
        by_name: Dict[str, float] = {}
        for launch in work:
            for e in device.get(launch.correlation_id(), ()):
                start = e.start_ns()
                records.append((e.name(), start, start + e.duration_ns()))
                by_name[e.name()] = (by_name.get(e.name(), 0.0)
                                     + e.duration_ns() / 1e9)
        launches = [e for e in work if _LAUNCH_API.search(e.name())]
        records.sort(key=lambda r: r[1])
        return {"records": records,
                "busy_s": union_s(records),
                "window_s": (self.end_ns - self.split_ns) / 1e9,
                "start_ns": self.split_ns, "end_ns": self.end_ns,
                "by_name": by_name,
                "unmatched_first": sum(e.correlation_id() not in device
                                       for e in launches[:FIRST])}


def union_s(records) -> float:
    """Seconds covered by the union of (name, start_ns, end_ns) records
    sorted by start."""
    total = 0
    cur_s = cur_e = None
    for _, s, e in records:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e9


def idle_gaps(records, start_ns: int, end_ns: int) -> List[Tuple[int, int]]:
    """The (start_ns, end_ns) intervals of the window in which no device
    record runs."""
    gaps, cursor = [], start_ns
    for _, s, e in records:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if end_ns > cursor:
        gaps.append((cursor, end_ns))
    return gaps


def kernel_seconds(records, pattern: str) -> float:
    """Device seconds of the records whose name matches ``pattern``."""
    rx = re.compile(pattern)
    return sum(e - s for name, s, e in records if rx.search(name)) / 1e9
