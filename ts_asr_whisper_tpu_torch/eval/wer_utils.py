"""WER utilities shared by the engines in eval/wer.py.

Mirrors the reference's wer.py / wer_utils.py seam
(the reference's src/utils/wer_utils.py): pseudo word timings and
per-speaker word streams, VAD-mask construction and group splitting for
chunked tcORC, non-overlapping hypothesis stream merging, and error
aggregation across sessions. Pure host-side numpy; no engine logic here.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from .seglst import SegLST

# ---------------------------------------------------------------------------
# word streams with pseudo timings
# ---------------------------------------------------------------------------


class _Vocab:
    def __init__(self):
        self.map: Dict[str, int] = {}

    def __getitem__(self, w: str) -> int:
        if w not in self.map:
            self.map[w] = len(self.map)
        return self.map[w]


def _segment_word_times(seg, style: str):
    """Character-proportional pseudo word timings within the segment
    (meeteval 'character_based'); 'points' collapses each word interval to
    its center (meeteval 'character_based_points', the tcpWER hyp default)."""
    words = str(seg["words"]).split()
    if not words:
        return []
    start, end = float(seg["start_time"]), float(seg["end_time"])
    dur = max(end - start, 0.0)
    lens = np.array([max(len(w), 1) for w in words], dtype=np.float64)
    bounds = np.concatenate([[0.0], np.cumsum(lens)]) / lens.sum()
    out = []
    for i, w in enumerate(words):
        wb = start + bounds[i] * dur
        we = start + bounds[i + 1] * dur
        if style == "points":
            c = 0.5 * (wb + we)
            out.append((w, c, c))
        else:
            out.append((w, wb, we))
    return out


def _speaker_streams(seglst: SegLST, vocab: _Vocab, style: str):
    """{speaker: (ids int32, begin f64, end f64)}, segments in start order."""
    out = {}
    for spk, segs in seglst.groupby("speaker").items():
        words, begins, ends = [], [], []
        for seg in segs.sorted("start_time"):
            for w, wb, we in _segment_word_times(seg, style):
                words.append(vocab[w])
                begins.append(wb)
                ends.append(we)
        out[spk] = (np.asarray(words, np.int32),
                    np.asarray(begins, np.float64),
                    np.asarray(ends, np.float64))
    return out


# ---------------------------------------------------------------------------
# VAD masks + group splitting (reference wer_utils.py:95-131)
# ---------------------------------------------------------------------------


def create_vad_mask(segments, time_step=0.1, total_duration=None) -> np.ndarray:
    if total_duration is None:
        total_duration = max(float(s["end_time"]) for s in segments)
    mask = np.zeros(int(float(total_duration) / time_step) + 1, dtype=bool)
    for s in segments:
        mask[int(float(s["start_time"]) / time_step):
             int(float(s["end_time"]) / time_step)] = 1
    return mask


def find_group_splits(vad, group_duration=30, time_step=0.1) -> List[int]:
    non_active = np.argwhere(~vad).squeeze(axis=-1)
    splits = []
    shift = group_duration / time_step
    next_offset = shift
    for i in non_active:
        if i >= next_offset:
            splits.append(int(i))
            next_offset = i + shift
    return splits


def _map_to_split(t: float, splits: Sequence[float]) -> int:
    for i, s in enumerate(splits):
        if t < s:
            return i
    return len(splits)


def merge_streams(hyp: SegLST) -> SegLST:
    """Merge non-overlapping speaker streams (wer_utils.py:63-92) to bound
    the ORC stream count."""
    groups = hyp.groupby("speaker")
    masks = {spk: create_vad_mask(segs.segments, time_step=0.01)
             for spk, segs in groups.items()}
    if masks:
        longest = max(len(m) for m in masks.values())
        masks = {k: np.pad(m, (0, longest - len(m))) for k, m in masks.items()}
    while True:
        found = None
        keys = list(groups)
        for a in keys:
            for b in keys:
                if a != b and not (masks[a] & masks[b]).any():
                    found = (a, b)
                    break
            if found:
                break
        if not found:
            break
        a, b = found
        moved = groups[b].map(lambda s: {**s, "speaker": a})
        groups[a] = groups[a] + moved
        masks[a] = masks[a] | masks[b]
        del groups[b], masks[b]
    return SegLST([s for g in groups.values() for s in g]).sorted("start_time")


# ---------------------------------------------------------------------------
# aggregation across sessions (reference wer_utils.py:167-182)
# ---------------------------------------------------------------------------


def aggregate_wer_metrics(rows: List[dict],
                          metrics_list: List[str]) -> Dict[str, float]:
    """Sum numeric fields across sessions, recompute rates
    (wer_utils.py:167-182)."""
    metrics: Dict[str, float] = {}
    numeric_keys = set()
    for row in rows:
        for k, v in row.items():
            if isinstance(v, (int, float, np.integer, np.floating)):
                numeric_keys.add(k)
    for k in numeric_keys:
        metrics[k] = float(sum(row.get(k, 0) for row in rows))
    for metric in metrics_list:
        prefix = metric.split("_", maxsplit=1)[0]
        if f"{prefix}_errors" in metrics and f"{prefix}_length" in metrics:
            denom = max(metrics[f"{prefix}_length"], 1.0)
            metrics[f"{prefix}_wer"] = metrics[f"{prefix}_errors"] / denom
        for k in ("missed_speaker", "falarm_speaker", "scored_speaker"):
            key = f"{prefix}_{k}"
            if key in metrics:
                metrics[f"{prefix}_mean_{k}"] = metrics[key] / max(len(rows), 1)
                del metrics[key]
    return metrics
