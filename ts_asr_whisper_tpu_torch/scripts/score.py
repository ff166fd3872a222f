"""Offline re-scoring of a predictions directory (reference utils/score.py).

Counterpart of scripts/score.py over the port's copy of eval/wer.py:

    python -m ts_asr_whisper_tpu_torch.scripts.score <pred_dir>
        [--metrics tcp_wer cp_wer] [--collar 5] [--workers 4]

Walks <pred_dir>/wer/<session>/ dirs containing tcp_wer_hyp.json,
tc_orc_wer_hyp.json and ref.json, recomputes the WER metrics in a process
pool, and writes all_session_wer.csv + aggregate metrics.
"""

from __future__ import annotations

import argparse
import csv
import json
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

from ..eval.wer import aggregate_wer_metrics, calc_wer


def score_session(args):
    base, metrics_list, collar = args
    return calc_wer(base, base / "tcp_wer_hyp.json",
                    base / "tc_orc_wer_hyp.json", base / "ref.json",
                    collar=collar, metrics_list=metrics_list)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("pred_dir", type=Path)
    ap.add_argument("--metrics", nargs="+", default=["tcp_wer", "cp_wer"])
    ap.add_argument("--collar", type=int, default=5)
    ap.add_argument("--workers", type=int, default=4)
    args = ap.parse_args(argv)

    sessions = sorted((args.pred_dir / "wer").glob("*/"))
    jobs = [(s, args.metrics, args.collar) for s in sessions
            if (s / "ref.json").exists()]
    rows = []
    with ProcessPoolExecutor(
            max_workers=args.workers,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        for out in pool.map(score_session, jobs):
            rows.extend(out)

    csv_path = args.pred_dir / "all_session_wer.csv"
    keys = sorted({k for r in rows for k in r})
    with open(csv_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        for r in rows:
            w.writerow({k: r.get(k) for k in keys})
    agg = aggregate_wer_metrics(rows, args.metrics)
    print(json.dumps(agg, indent=2, default=float))


if __name__ == "__main__":
    main()
