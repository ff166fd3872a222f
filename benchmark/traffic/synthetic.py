"""The benchmark's corpus generator: recordings (WAV) and a MonoCut
jsonl.gz manifest in the format that the port's ``data/manifests.py``
loads.

Started as a copy of the port's ``data/synthetic.py::write_corpus`` (two
speakers, fixed 4 s turns, no overlap), extended here: 2-4 speakers, turns
of drawn lengths with overlap between them, durations drawn inside ranges,
a voiced tone per speaker over a noise floor. A traffic mix
(``benchmark/traffic/<name>.json``) gives the parameters; ``--seed`` draws
the rest. The sizes that set the work (rows, windows a row, batches) come
from the mix alone, so every seed does the same work in another order.
"""

from __future__ import annotations

import gzip
import json
import math
import wave
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Sequence

import numpy as np

SAMPLE_RATE = 16000
WORDS = ("good morning to everyone here thanks for coming today folks we "
         "will start with the budget and then the schedule").split()


@dataclass
class Recording:
    id: str
    duration: float
    speakers: List[str]
    # (speaker, start s, duration s, text), in time order
    turns: List[tuple] = field(default_factory=list)
    path: str = ""


def draw_turns(rng: np.random.Generator, duration: float,
               speakers: Sequence[str], turn_s: Sequence[float],
               overlap: float) -> List[tuple]:
    """Speaker turns over [0.3, duration - 0.3]: each speaker once in a
    drawn order first, then a drawn speaker other than the last; a turn
    starts ``overlap`` of the last turn's length before that turn's end, or
    after a short pause one time in four."""
    turns, t, last = [], 0.3, None
    order = list(rng.permutation(len(speakers)))
    while t + 1.0 < duration - 0.3:
        if order:
            k = int(order.pop(0))
        else:
            k = int(rng.choice([i for i in range(len(speakers))
                                if i != last]))
        d = float(min(rng.uniform(*turn_s), duration - 0.3 - t))
        n_words = max(2, int(d * 2.5))
        text = " ".join(rng.choice(WORDS, size=n_words))
        turns.append((speakers[k], round(t, 2), round(d, 2), text))
        last = k
        if rng.random() < 0.25:
            t = t + d + float(rng.uniform(0.2, 1.0))
        else:
            t = t + d * (1.0 - overlap)
    return turns


def synthesize(rng: np.random.Generator, rec: Recording) -> np.ndarray:
    """A noise floor and, in each turn, a voiced tone of the speaker's
    pitch with a few harmonics and a syllable-rate envelope."""
    n = int(round(rec.duration * SAMPLE_RATE))
    wav = 0.01 * rng.standard_normal(n, dtype=np.float32)
    pitch = {s: float(rng.uniform(100.0, 240.0)) for s in rec.speakers}
    for spk, start, dur, _ in rec.turns:
        a = int(start * SAMPLE_RATE)
        b = min(n, a + int(dur * SAMPLE_RATE))
        t = np.arange(b - a, dtype=np.float32) / SAMPLE_RATE
        f0 = pitch[spk]
        env = 0.5 + 0.5 * np.sin(2 * np.pi * 4.0 * t) ** 2
        tone = sum(np.sin(2 * np.pi * f0 * h * t) / h for h in (1, 2, 3))
        wav[a:b] += (0.08 * env * tone).astype(np.float32)
    return wav


def write_wav(path: Path, samples: np.ndarray) -> None:
    """16-bit PCM mono, as the port's ``data/audio.py::save_wav``."""
    pcm = np.clip(samples * 32767.0, -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SAMPLE_RATE)
        w.writeframes(pcm.tobytes())


def read_wav(path: str) -> np.ndarray:
    """The samples as float32 in [-1, 1)."""
    with wave.open(str(path), "rb") as w:
        raw = w.readframes(w.getnframes())
    return np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0


def plan_batches(mix: dict, n_batches: int, seed: int,
                 tag: str) -> List[Recording]:
    """``n_batches`` copies of the mix's batch template, each recording's
    duration drawn inside its slot's range and the slots of a batch in a
    drawn order, with its turns drawn."""
    rng = np.random.default_rng([seed, zlib_tag(tag)])
    recs = []
    for bi in range(n_batches):
        slots = mix["batch_template"]
        for si in rng.permutation(len(slots)):
            slot = slots[int(si)]
            dur = round(float(rng.uniform(*slot["seconds"])), 2)
            spk = [f"{tag}{bi}s{si}spk{k}" for k in range(slot["speakers"])]
            rec = Recording(id=f"{tag}{bi}_{int(si)}", duration=dur,
                            speakers=spk)
            rec.turns = draw_turns(rng, dur, spk, mix["turn_seconds"],
                                   float(rng.uniform(*mix["overlap"])))
            recs.append(rec)
    return recs


def zlib_tag(tag: str) -> int:
    import zlib
    return zlib.crc32(tag.encode())


def write_corpus(out_dir, recs: List[Recording], seed: int,
                 name: str) -> Path:
    """Write the recordings and their manifest; returns its path."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng([seed, zlib_tag(name), 1])
    cuts = []
    for rec in recs:
        rec.path = str(out_dir / f"{rec.id}.wav")
        wav = synthesize(rng, rec)
        write_wav(Path(rec.path), wav)
        n = wav.shape[0]
        recording = {"id": rec.id,
                     "sources": [{"type": "file", "channels": [0],
                                  "source": rec.path}],
                     "sampling_rate": SAMPLE_RATE, "num_samples": n,
                     "duration": rec.duration}
        sups = [{"id": f"{rec.id}-{k}", "recording_id": rec.id,
                 "start": start, "duration": dur, "channel": 0,
                 "text": text, "speaker": spk, "language": "en"}
                for k, (spk, start, dur, text) in enumerate(rec.turns)]
        cuts.append({"id": f"{rec.id}_cut", "start": 0.0,
                     "duration": rec.duration, "channel": 0,
                     "supervisions": sups, "recording": recording,
                     "type": "MonoCut"})
    manifest = out_dir / f"{name}.jsonl.gz"
    with gzip.open(manifest, "wt") as f:
        for c in cuts:
            f.write(json.dumps(c) + "\n")
    return manifest


def mel_frames(duration: float) -> int:
    """Valid mel frames of a recording (one per 160 samples begun)."""
    return math.ceil(int(round(duration * SAMPLE_RATE)) / 160)


def rows(recs: Sequence[Recording]) -> List[tuple]:
    """(recording, speaker) in the order of the port's datasets: cut by
    cut, the speakers sorted."""
    return [(r, s) for r in recs for s in sorted(r.speakers)]
