"""Micro-batch ceiling of the fine-tune on one card.

Counterpart of scripts/probe_train_batch.py. For each micro-batch size in
--batches it runs the memory probe of ``auto_find_batch_size``
(``training/trainer.py::Trainer.probe_step``: one forward and backward of
the ``+train=dicow_v3`` base phase, decoder frozen, with the base phase's
optimizer state held and no update) on rows of 30 s from a synthetic corpus,
with the labels made the widest the collator can give
(``train.py::probe_batch``), and prints one JSON line per size:
samples/s over the median of the timed probes and the peak device memory,
or the out-of-memory error. An out-of-memory error at one size is a result:
the next size still runs. Any other error is raised.

    python -m ts_asr_whisper_tpu_torch.scripts.probe_train_batch \
        [--batches 4 8 12 16] [--model large-v3-turbo] \
        [--device cuda|cuda:N|cpu]

Random weights from the config's seed; the model is built once. The last
line lists the kernel launches of the whole run.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import tempfile
import time
from pathlib import Path

import torch

from .. import kernels
from ..config import load_config
from ..data.synthetic import write_corpus
from ..train import ModelTrainer, _is_oom, probe_batch
from ..training.trainer import Trainer, to_device

WARMUP, REPS = 1, 3


def overrides(model: str, manifest: Path, batch: int, out_dir: Path) -> list:
    """+train=dicow_v3 without its env-var paths, in the base phase from
    the first step (the probe holds the base phase's memory either way)."""
    return ["+train=dicow_v3", f"model.whisper_model={model}",
            "model.reinit_encoder_from=null",
            f"data.train_cutsets=[{manifest}]",
            "data.dev_cutsets=[]", "data.eval_cutsets=[]",
            "data.dataset_weights=null", "aug.musan_root=null",
            "training.overall_batch_size=0",
            f"training.per_device_train_batch_size={batch}",
            "training.use_fddt_only_n_steps=0",
            "training.use_fddt_only_n_epochs=0",
            "training.eval_strategy=no", "training.save_strategy=no",
            f"training.output_dir={out_dir}"]


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, nargs="+", default=[4, 8, 12, 16])
    ap.add_argument("--model", default="large-v3-turbo")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), cuda:N or cpu")
    args = ap.parse_args(argv)

    from ..__main__ import resolve_device
    from ..decode import no_tf32

    dev = resolve_device(args.device)
    no_tf32()
    cuda = dev.type == "cuda"
    with tempfile.TemporaryDirectory() as td:
        n_rows = max(args.batches)
        # two target-speaker rows per recording
        manifest = write_corpus(Path(td) / "corpus",
                                [30.0] * (-(-n_rows // 2)), seed=1)
        cfg = load_config(overrides(args.model, manifest, n_rows,
                                    Path(td) / "exp"))
        mt = ModelTrainer(cfg, dev)
        trainer = Trainer(cfg, mt.model, num_prefix_tokens=len(
            mt.container.tokenizer.prefix_tokens) - 1)
        width = mt.probe_width()
        rows = [mt.train_dataset[i] for i in range(n_rows)]
        print(f"device: {dev} "
              f"{torch.cuda.get_device_name(dev) if cuda else ''}; model "
              f"{args.model}, +train=dicow_v3 base phase, labels {width} "
              "wide", flush=True)
        for b in args.batches:
            batch = to_device(probe_batch(mt.collator(rows[:b]), width), dev)
            if cuda:
                torch.cuda.reset_peak_memory_stats(dev)
            times, error = [], None
            try:
                for i in range(WARMUP + REPS):
                    sync(dev)
                    t0 = time.perf_counter()
                    trainer.probe_step(batch)
                    sync(dev)
                    if i >= WARMUP:
                        times.append(time.perf_counter() - t0)
            except Exception as e:  # noqa: BLE001  (only OOM is a result)
                if not _is_oom(e):
                    raise
                error = f"{type(e).__name__}: {str(e)[:160]}"
            rec = {"batch": b, "ok": error is None}
            if error is None:
                rates = [b / s for s in times]
                rec.update(samples_per_s=round(statistics.median(rates), 2),
                           spread=round(max(rates) - min(rates), 2))
            else:
                rec["error"] = error
            if cuda:
                rec["peak_gib"] = round(
                    torch.cuda.max_memory_allocated(dev) / 2**30, 2)
            print(json.dumps(rec), flush=True)
            del batch
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
    print("kernel launches: " + json.dumps(kernels.launch_counts))


if __name__ == "__main__":
    main()
