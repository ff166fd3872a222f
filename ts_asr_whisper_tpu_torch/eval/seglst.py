"""SegLST (segment-wise long-form transcription) structures and session
processing — the meeteval-compatible exchange format the reference uses
(the reference's src/utils/general.py:70-104, evaluation.py:124-176)."""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Callable, Dict, Iterable, List

import numpy as np

from .postprocess import truncate_at_repeating_ngram

Segment = Dict[str, object]  # session_id, start_time, end_time, words, speaker


class SegLST:
    def __init__(self, segments: Iterable[Segment]):
        self.segments: List[Segment] = list(segments)

    def __len__(self):
        return len(self.segments)

    def __iter__(self):
        return iter(self.segments)

    def __add__(self, other):
        return SegLST(self.segments + list(other))

    def map(self, fn: Callable[[Segment], Segment]) -> "SegLST":
        return SegLST([fn(dict(s)) for s in self.segments])

    def filter(self, fn: Callable[[Segment], bool]) -> "SegLST":
        return SegLST([s for s in self.segments if fn(s)])

    def sorted(self, key: str) -> "SegLST":
        return SegLST(sorted(self.segments, key=lambda s: s[key]))

    def groupby(self, key: str) -> Dict[object, "SegLST"]:
        out: Dict[object, SegLST] = {}
        for s in self.segments:
            out.setdefault(s[key], SegLST([])).segments.append(s)
        return out

    def dump(self, path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            json.dump([{**s, "start_time": float(s["start_time"]),
                        "end_time": float(s["end_time"])}
                       for s in self.segments], f, indent=2)

    @classmethod
    def load(cls, path) -> "SegLST":
        with open(path) as f:
            return cls(json.load(f))


def create_dummy_seglst(session_id: str) -> SegLST:
    return SegLST([{"session_id": session_id, "start_time": 0.0,
                    "end_time": 0.0, "speaker": "", "words": ""}])


def normalize_segment(segment: Segment, tn: Callable[[str], str]) -> Segment:
    segment["words"] = tn(segment["words"])
    return segment


def filter_empty_segments(seglst: SegLST) -> SegLST:
    return seglst.filter(lambda s: s["words"] != "")


def supervisions_to_seglst(supervisions, session_id: str) -> SegLST:
    return SegLST([
        {"session_id": session_id, "start_time": float(s.start),
         "end_time": float(s.end), "words": s.text or "",
         "speaker": s.speaker}
        for s in supervisions
    ])


_TIME_RE = re.compile(r"<\|([\d.]+)\|>")


def parse_string_to_objects(s: str) -> List[dict]:
    """Timestamped decode string -> [{'start','end','text'}]
    (evaluation.py:124-147)."""
    times = _TIME_RE.findall(s)
    text_segments = _TIME_RE.split(s)[1:]
    objects = []
    for i in range(len(times) - 1):
        text = text_segments[2 * i + 1].strip()
        if text:
            objects.append({"start": float(times[i]),
                            "end": float(times[i + 1]),
                            "text": text})
    return objects


def process_session(
    session_preds: np.ndarray,
    tokenizer,
    spk_id: str,
    cut,
    break_to_characters: bool = False,
    overflow_margin: float = 5.0,
):
    """One (recording, speaker) token stream -> attributed segments
    (evaluation.py:150-176)."""
    from ..data.datasets import get_cut_recording_id

    preds = np.asarray(session_preds).copy()
    preds[preds == -100] = tokenizer.pad_token_id
    transcript = tokenizer.decode(preds, decode_with_timestamps=True,
                                  skip_special_tokens=True)
    segments = parse_string_to_objects(transcript)
    cut_duration = cut.duration
    cut_start = getattr(cut, "start", 0.0) or 0.0
    for segment in segments:
        text = segment["text"]
        if break_to_characters:
            from ..data.datasets import LhotseLongFormDataset

            text = LhotseLongFormDataset.add_space_between_chars(text)
        if segment["end"] <= cut_duration + overflow_margin:
            yield {
                "session_id": get_cut_recording_id(cut),
                "start_time": segment["start"] + cut_start,
                "end_time": segment["end"] + cut_start,
                "words": truncate_at_repeating_ngram(text),
                "speaker": spk_id,
            }
