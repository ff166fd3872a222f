"""Synthetic two-speaker corpus for smoke runs and tests: WAV files and a
MonoCut jsonl.gz manifest in the format that ``data/manifests.py`` loads (the
format of tests/test_end_to_end.py). The audio is a tone plus noise; the
supervisions alternate between two speakers, so every recording yields two
target-speaker rows."""

from __future__ import annotations

import gzip
import json
from pathlib import Path
from typing import Sequence

import numpy as np

from .audio import save_wav

SAMPLE_RATE = 16000
WORDS = ("good morning to everyone here thanks for coming today folks we "
         "will start with the budget and then the schedule").split()


def write_corpus(out_dir, durations: Sequence[float], seed: int = 0,
                 turn: float = 4.0) -> Path:
    """Write ``len(durations)`` recordings and return the manifest path.
    Speaker turns of ``turn`` seconds alternate between spkA and spkB."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    cuts = []
    for i, dur in enumerate(durations):
        n = int(SAMPLE_RATE * dur)
        t = np.arange(n) / SAMPLE_RATE
        wav = (0.1 * np.sin(2 * np.pi * 220 * t)
               + 0.02 * rng.standard_normal(n)).astype(np.float32)
        rec_id = f"rec{i}"
        path = out_dir / f"{rec_id}.wav"
        save_wav(str(path), wav, SAMPLE_RATE)
        rec = {"id": rec_id,
               "sources": [{"type": "file", "channels": [0],
                            "source": str(path)}],
               "sampling_rate": SAMPLE_RATE, "num_samples": n,
               "duration": dur}
        sups = []
        start, k = 0.5, 0
        while start + 1.0 < dur:
            d = min(turn - 0.5, dur - start)
            spk = "spkA" if k % 2 == 0 else "spkB"
            text = " ".join(rng.choice(WORDS, size=max(2, int(d * 2))))
            sups.append({"id": f"{rec_id}-{spk}-{k}", "recording_id": rec_id,
                         "start": round(start, 2), "duration": round(d, 2),
                         "channel": 0, "text": text, "speaker": spk,
                         "language": "en"})
            start += turn
            k += 1
        cuts.append({"id": f"{rec_id}_cut", "start": 0.0, "duration": dur,
                     "channel": 0, "supervisions": sups, "recording": rec,
                     "type": "MonoCut"})
    manifest = out_dir / "eval_cutset.jsonl.gz"
    with gzip.open(manifest, "wt") as f:
        for c in cuts:
            f.write(json.dumps(c) + "\n")
    return manifest
