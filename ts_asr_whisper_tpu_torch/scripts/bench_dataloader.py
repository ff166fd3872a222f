"""Dataloader throughput benchmark: samples/s through the full host path
(WAV read -> mel featurization -> STNO masks -> collation) with the
threaded DataLoader.

Counterpart of scripts/bench_dataloader.py over the port's copies of
data/* and training/dataloader.py:

    python -m ts_asr_whisper_tpu_torch.scripts.bench_dataloader \
        [--n-cuts 256] [--batch 8] [--workers 4] [--worker-type thread]
        [--device-mel [--device cuda|cpu]] [--sweep]

The numpy host mel is the default; --device-mel featurizes each sample
through ops/mel.py on --device instead (the card unless ``--device cpu``;
the round trip per sample is the cost it shows). Prints one JSON line per
measurement.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import statistics
import tempfile
import time
from pathlib import Path

import numpy as np

from ..data import datasets as ds_mod
from ..data.audio import save_wav
from ..data.collators import DataCollator
from ..data.datasets import TS_ASR_Dataset, load_cutsets
from ..data.tokenizer import ByteLevelTokenizer
from ..training.dataloader import DataLoader


def make_corpus(tmp: Path, n_cuts: int, duration: float):
    sr = 16000
    rng = np.random.default_rng(0)
    cuts = []
    wav = (0.05 * rng.standard_normal(int(sr * duration))).astype(np.float32)
    save_wav(str(tmp / "shared.wav"), wav, sr)
    for i in range(n_cuts):
        rec = {"id": f"r{i}",
               "sources": [{"type": "file", "channels": [0],
                            "source": str(tmp / "shared.wav")}],
               "sampling_rate": sr, "num_samples": len(wav),
               "duration": duration}
        sups = [{"id": f"r{i}-A", "recording_id": f"r{i}", "start": 0.5,
                 "duration": duration - 1, "channel": 0,
                 "text": "hello world", "speaker": "A", "language": "en"}]
        cuts.append({"id": f"r{i}_cut", "start": 0.0, "duration": duration,
                     "channel": 0, "supervisions": sups, "recording": rec,
                     "type": "MonoCut"})
    path = tmp / "cuts.jsonl.gz"
    with gzip.open(path, "wt") as f:
        for c in cuts:
            f.write(json.dumps(c) + "\n")
    return path


def build_pipeline(manifest: Path):
    """(dataset, collator) of the benchmark, as the JAX script builds
    them."""
    cutsets = load_cutsets([str(manifest)], False)
    dataset = TS_ASR_Dataset(cutsets, text_norm=lambda x: x,
                             use_timestamps=True, num_mel_bins=80,
                             global_lang_id="en")
    collator = DataCollator(tokenizer=ByteLevelTokenizer(),
                            bos_token_id=0, max_length=64)
    return dataset, collator


def use_device_mel(device) -> None:
    """Featurize every sample through ops/mel.py on ``device`` (the
    dataset's ``extract_features`` replaced): the samples go up one by
    one and their features come back."""
    import torch

    from ..data.features import HOP_LENGTH, N_SAMPLES
    from ..ops.mel import log_mel_spectrogram

    def device_extract(waveform, num_mel_filters=80,
                       pad_to_multiple_of=N_SAMPLES):
        waveform = np.asarray(waveform, np.float32).reshape(-1)
        n = waveform.shape[0]
        padded_len = int(np.ceil(max(n, 1) / pad_to_multiple_of)) \
            * pad_to_multiple_of
        padded = np.zeros(padded_len, np.float32)
        padded[:n] = waveform
        mask = np.zeros(padded_len, np.int32)
        mask[:n] = 1
        feats = log_mel_spectrogram(
            torch.from_numpy(padded).to(device)[None], num_mel_filters)[0]
        return feats.cpu().numpy(), mask[::HOP_LENGTH]

    ds_mod.extract_features = device_extract


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n-cuts", type=int, default=256)
    p.add_argument("--duration", type=float, default=30.0)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--worker-type", choices=("thread", "process"),
                   default="thread")
    p.add_argument("--device-mel", action="store_true",
                   help="featurize each sample on --device (ops/mel.py)")
    p.add_argument("--device", default="cuda",
                   help="the device of --device-mel: cuda (default), "
                        "cuda:N or cpu")
    p.add_argument("--sweep", action="store_true",
                   help="emit samples/s at workers=1/4/8 (process workers "
                        "past 1)")
    args = p.parse_args(argv)

    if args.device_mel:
        from ..__main__ import resolve_device

        use_device_mel(resolve_device(args.device))

    with tempfile.TemporaryDirectory() as td:
        manifest = make_corpus(Path(td), args.n_cuts, args.duration)
        dataset, collator = build_pipeline(manifest)
        cores = (len(os.sched_getaffinity(0))
                 if hasattr(os, "sched_getaffinity")
                 else (os.cpu_count() or 1))

        def measure(workers, worker_type):
            loader = DataLoader(dataset, collator, batch_size=args.batch,
                                num_workers=workers, prefetch_factor=4,
                                num_epochs=1, shuffle=False,
                                worker_type=worker_type)
            # warmup one batch (fft plan caches, file cache, worker forks)
            next(iter(loader))
            t0 = time.perf_counter()
            n = 0
            for batch in loader:
                n += batch["input_features"].shape[0]
            return n / (time.perf_counter() - t0)

        def emit(rate, workers, worker_type, spread=None):
            rec = {
                "metric": f"dataloader_samples_per_s_w{workers}",
                "value": round(rate, 2),
                "unit": "samples_per_s",
                "device_mel": bool(args.device_mel),
                "workers": workers,
                "worker_type": worker_type,
                "host_cores": cores,
            }
            if spread is not None:
                rec["spread"] = round(spread, 2)
            print(json.dumps(rec), flush=True)

        if args.sweep:
            # worker scaling is core-bound: with fewer cores than workers
            # the extra workers only measure contention. Median of 3 with
            # the spread, so that drift can be told from a regression
            for workers, worker_type in ((1, "thread"), (4, "process"),
                                         (8, "process")):
                rates = [measure(workers, worker_type) for _ in range(3)]
                emit(statistics.median(rates), workers, worker_type,
                     spread=max(rates) - min(rates))
        else:
            emit(measure(args.workers, args.worker_type), args.workers,
                 args.worker_type)


if __name__ == "__main__":
    main()
