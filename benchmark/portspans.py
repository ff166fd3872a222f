"""The port's own spans and counters in a traced window, for the per-layer
readers: ``ts_asr_whisper_tpu_torch.utils.observability`` records them on
``time.time_ns()``, the clock of the trace's device records, while the
profiler runs. A port without them (no ``spans_between``), or a window in
which it recorded no span, gives None."""

from __future__ import annotations

from collections import Counter
from typing import Iterable, List, Optional, Tuple

Interval = Tuple[int, int]


class Window:
    def __init__(self, spans, counts: dict, records):
        self.spans = spans
        self.counts = counts
        self.records = records
        self._n = Counter(s.name for s in spans)

    def n(self, name: str) -> int:
        """The spans of ``name`` in the window."""
        return self._n[name]

    def total_ms(self, *names: str) -> float:
        """Summed length of the spans of ``names``, clipped to the window."""
        return sum(s.end_ns - s.start_ns for s in self.spans
                   if s.name in names) / 1e6

    def intervals(self, *names: str) -> List[Interval]:
        """The union of the spans of ``names``, sorted and disjoint."""
        return merged((s.start_ns, s.end_ns) for s in self.spans
                      if s.name in names)

    def busy_ms(self, *names: str) -> float:
        """Device time (the union of the trace's records) inside the spans
        of ``names``."""
        return overlap_ns(merged((s, e) for _, s, e in self.records),
                          self.intervals(*names)) / 1e6

    def idle_ms(self, *names: str) -> float:
        """Time inside the spans of ``names`` in which no device record
        runs."""
        inside = sum(e - s for s, e in self.intervals(*names)) / 1e6
        return inside - self.busy_ms(*names)


def window(ctx: dict) -> Optional[Window]:
    tr = ctx.get("trace")
    if tr is None:
        return None
    try:
        from ts_asr_whisper_tpu_torch.utils import observability
    except ImportError:
        return None
    between = getattr(observability, "spans_between", None)
    counts = getattr(observability, "counts_between", None)
    if between is None or counts is None:
        return None
    spans = between(tr["start_ns"], tr["end_ns"])
    if not spans:
        return None
    return Window(spans, counts(tr["start_ns"], tr["end_ns"]),
                  tr["records"])


def merged(intervals: Iterable[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def overlap_ns(a: List[Interval], b: List[Interval]) -> int:
    """Length of the intersection of two sorted, disjoint interval lists."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def per(value: float, n) -> Optional[float]:
    """``value / n``, or None when there is nothing to divide by."""
    return value / n if n else None
