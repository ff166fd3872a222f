"""Cut/supervision manifests — lhotse-jsonl.gz-compatible, dependency-free.

Reads the same ``*.jsonl.gz`` cut manifests the reference consumes with
lhotse (the reference's src/data/local_datasets.py:601-624): MonoCut and
MixedCut records with nested Recording/SupervisionSegment dicts. Implements
exactly the surface the TS-ASR pipeline needs (load_audio,
speakers_audio_mask, per-speaker supervision access, mixing), not all of
lhotse.
"""

from __future__ import annotations

import gzip
import json
from dataclasses import dataclass, field, replace
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, Optional, Union

import numpy as np

from .audio import load_audio


@dataclass
class SupervisionSegment:
    id: str = ""
    recording_id: str = ""
    start: float = 0.0        # relative to the enclosing cut
    duration: float = 0.0
    channel: Union[int, List[int]] = 0
    text: Optional[str] = None
    speaker: Optional[str] = None
    language: Optional[str] = None
    custom: Optional[dict] = None

    @property
    def end(self) -> float:
        return self.start + self.duration

    @classmethod
    def from_dict(cls, d: dict) -> "SupervisionSegment":
        known = {k: d.get(k) for k in
                 ("id", "recording_id", "start", "duration", "channel",
                  "text", "speaker", "language", "custom")}
        known = {k: v for k, v in known.items() if v is not None}
        return cls(**known)


@dataclass
class AudioSource:
    type: str = "file"
    channels: List[int] = field(default_factory=lambda: [0])
    source: str = ""


@dataclass
class Recording:
    id: str
    sources: List[AudioSource]
    sampling_rate: int
    num_samples: int
    duration: float

    @classmethod
    def from_dict(cls, d: dict) -> "Recording":
        return cls(
            id=d["id"],
            sources=[AudioSource(s.get("type", "file"), s.get("channels", [0]),
                                 s["source"]) for s in d.get("sources", [])],
            sampling_rate=d["sampling_rate"],
            num_samples=d["num_samples"],
            duration=d["duration"],
        )

    def load_audio(self, channels: Optional[List[int]] = None,
                   offset: float = 0.0,
                   duration: Optional[float] = None) -> np.ndarray:
        parts = []
        for src in self.sources:
            samples, sr = load_audio(src.source, offset=offset,
                                     duration=duration,
                                     target_sr=self.sampling_rate)
            parts.append(samples)
        audio = np.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]
        if channels is not None:
            audio = audio[channels]
        return audio


@dataclass
class MonoCut:
    id: str
    start: float = 0.0
    duration: float = 0.0
    channel: Union[int, List[int]] = 0
    recording: Optional[Recording] = None
    supervisions: List[SupervisionSegment] = field(default_factory=list)
    custom: Optional[Dict[str, Any]] = None

    def __getattr__(self, name):
        custom = object.__getattribute__(self, "custom")
        if custom and name in custom:
            return custom[name]
        raise AttributeError(name)

    @property
    def end(self) -> float:
        return self.start + self.duration

    @property
    def recording_id(self) -> str:
        return self.recording.id if self.recording else self.id

    @property
    def sampling_rate(self) -> int:
        return self.recording.sampling_rate if self.recording else 16000

    @property
    def num_samples(self) -> int:
        return int(round(self.duration * self.sampling_rate))

    def load_audio(self, channels: Optional[List[int]] = None) -> np.ndarray:
        return self.recording.load_audio(
            channels=channels if channels is not None
            else ([self.channel] if isinstance(self.channel, int)
                  else self.channel),
            offset=self.start, duration=self.duration)

    @property
    def speakers(self):
        return sorted({s.speaker for s in self.supervisions if s.speaker})

    def speakers_audio_mask(self, speaker_to_idx_map: Dict[str, int]) -> np.ndarray:
        from .stno import speakers_audio_mask

        return speakers_audio_mask(self.supervisions, self.num_samples,
                                   speaker_to_idx_map, self.sampling_rate)

    def with_custom(self, key: str, value) -> "MonoCut":
        new = replace(self)
        new.custom = dict(self.custom or {})
        new.custom[key] = value
        return new

    @classmethod
    def from_dict(cls, d: dict) -> "MonoCut":
        return cls(
            id=d["id"],
            start=d.get("start", 0.0),
            duration=d.get("duration", 0.0),
            channel=d.get("channel", 0),
            recording=(Recording.from_dict(d["recording"])
                       if d.get("recording") else None),
            supervisions=[SupervisionSegment.from_dict(s)
                          for s in d.get("supervisions", [])],
            custom=d.get("custom"),
        )


@dataclass
class MixTrack:
    cut: MonoCut
    offset: float = 0.0


@dataclass
class MixedCut:
    id: str
    tracks: List[MixTrack]
    custom: Optional[Dict[str, Any]] = None

    def __getattr__(self, name):
        custom = object.__getattribute__(self, "custom")
        if custom and name in custom:
            return custom[name]
        raise AttributeError(name)

    @property
    def duration(self) -> float:
        return max((t.offset + t.cut.duration for t in self.tracks), default=0.0)

    @property
    def sampling_rate(self) -> int:
        return self.tracks[0].cut.sampling_rate

    @property
    def num_samples(self) -> int:
        return int(round(self.duration * self.sampling_rate))

    @property
    def recording_id(self) -> str:
        return self.id

    @property
    def supervisions(self) -> List[SupervisionSegment]:
        sups = []
        for t in self.tracks:
            for s in t.cut.supervisions:
                sups.append(replace(s, start=s.start + t.offset))
        return sups

    @property
    def speakers(self):
        return sorted({s.speaker for s in self.supervisions if s.speaker})

    def load_audio(self, channels=None) -> np.ndarray:
        sr = self.sampling_rate
        total = self.num_samples
        out = np.zeros((1, total), dtype=np.float32)
        for t in self.tracks:
            audio = t.cut.load_audio()
            if audio.shape[0] > 1:
                audio = audio[:1]
            start = int(round(t.offset * sr))
            end = min(start + audio.shape[1], total)
            out[:, start:end] += audio[:, : end - start]
        return out

    def speakers_audio_mask(self, speaker_to_idx_map: Dict[str, int]) -> np.ndarray:
        from .stno import speakers_audio_mask

        return speakers_audio_mask(self.supervisions, self.num_samples,
                                   speaker_to_idx_map, self.sampling_rate)

    @classmethod
    def from_dict(cls, d: dict) -> "MixedCut":
        return cls(
            id=d["id"],
            tracks=[MixTrack(cut=MonoCut.from_dict(t["cut"]),
                             offset=t.get("offset", 0.0))
                    for t in d.get("tracks", [])],
            custom=d.get("custom"),
        )


Cut = Union[MonoCut, MixedCut]


def cut_from_dict(d: dict) -> Cut:
    t = d.get("type", "MonoCut")
    if t == "MixedCut":
        return MixedCut.from_dict(d)
    return MonoCut.from_dict(d)


class CutSet:
    """Eager list of cuts with the lhotse surface the pipeline uses."""

    def __init__(self, cuts: Iterable[Cut]):
        self.cuts: List[Cut] = list(cuts)
        # runtime attributes the reference attaches (e.g. parent_cutset)
        self.parent_cutset: Optional["CutSet"] = None

    # -- IO -------------------------------------------------------------
    @classmethod
    def from_file(cls, path: Union[str, Path]) -> "CutSet":
        path = Path(path)
        opener = gzip.open if "".join(path.suffixes).endswith(".gz") else open
        cuts = []
        with opener(path, "rt") as f:
            for line in f:
                line = line.strip()
                if line:
                    cuts.append(cut_from_dict(json.loads(line)))
        return cls(cuts)

    def to_file(self, path: Union[str, Path]) -> None:
        path = Path(path)
        opener = gzip.open if str(path).endswith(".gz") else open
        with opener(path, "wt") as f:
            for cut in self.cuts:
                f.write(json.dumps(cut_to_dict(cut)) + "\n")

    # -- collection ops ---------------------------------------------------
    def __len__(self):
        return len(self.cuts)

    def __iter__(self):
        return iter(self.cuts)

    def __getitem__(self, i):
        return self.cuts[i]

    def __add__(self, other: "CutSet") -> "CutSet":
        return CutSet(self.cuts + list(other))

    def filter(self, fn: Callable[[Cut], bool]) -> "CutSet":
        return CutSet([c for c in self.cuts if fn(c)])

    def map(self, fn: Callable[[Cut], Cut]) -> "CutSet":
        return CutSet([fn(c) for c in self.cuts])

    def to_eager(self) -> "CutSet":
        return self

    def sample(self) -> Cut:
        return self.cuts[np.random.randint(len(self.cuts))]

    @property
    def speakers(self):
        out = set()
        for c in self.cuts:
            out.update(c.speakers)
        return sorted(out)

    @classmethod
    def from_cuts(cls, cuts: Iterable[Cut]) -> "CutSet":
        return cls(cuts)


def cut_to_dict(cut: Cut) -> dict:
    import dataclasses

    def enc(obj):
        if dataclasses.is_dataclass(obj):
            return {k: enc(v) for k, v in dataclasses.asdict(obj).items()
                    if v is not None}
        return obj

    if isinstance(cut, MixedCut):
        return {"type": "MixedCut", "id": cut.id,
                "tracks": [{"type": "MixTrack", "cut": enc(t.cut),
                            "offset": t.offset} for t in cut.tracks],
                **({"custom": cut.custom} if cut.custom else {})}
    d = enc(cut)
    d["type"] = "MonoCut"
    return d


def load_manifest(path: Union[str, Path]) -> CutSet:
    return CutSet.from_file(path)
