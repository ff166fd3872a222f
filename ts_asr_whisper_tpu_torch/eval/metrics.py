"""Long-form scoring of the port: token streams -> attributed SegLST ->
session WERs -> aggregate metrics; and the short-form WER/CER of encoder
pre-training.

A jax-free copy of ts_asr_whisper_tpu/eval/metrics.py:33-224
(``compute_longform_metrics`` and its helpers, ``compute_shortform_metrics``)
and of ts_asr_whisper_tpu/eval/seglst.py:102-134 (``process_session``). The
originals reach jax through ``data/datasets.py``; here only the imports
differ, and ``get_cut_recording_id`` / ``LhotseLongFormDataset`` come from
the port's dataset copy. The port keeps its own copies: it imports nothing
of the JAX package.
"""

from __future__ import annotations

import csv
import os
from functools import partial
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..data.datasets import get_cut_recording_id
from ..utils.logging_def import get_logger
from .postprocess import truncate_at_repeating_ngram
from .seglst import (
    SegLST,
    normalize_segment,
    parse_string_to_objects,
    supervisions_to_seglst,
)
from .wer import aggregate_wer_metrics, calc_wer

logger = get_logger(__name__)


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


def write_hypothesis_jsons(out_dir, session_id: str, segments: List[dict],
                           text_normalizer) -> dict:
    """SegLST hyp files for tcpWER and tcORC-WER (evaluation.py:82-121)."""
    base = Path(out_dir) / "wer" / session_id
    seglst = SegLST(segments).map(
        partial(normalize_segment, tn=text_normalizer))
    tcp_path = base / "tcp_wer_hyp.json"
    seglst.dump(tcp_path)
    tcorc_path = base / "tc_orc_wer_hyp.json"
    seglst.dump(tcorc_path)
    return {"session_id": session_id, "tcp_wer_hyp_json": tcp_path,
            "tcorc_wer_hyp_json": tcorc_path}


def save_session_outputs(processed_sessions: Dict[str, List[dict]],
                         out_dir, text_norm, references_cs) -> None:
    """Write hyp + ref SegLST per session (evaluation.py:191-214)."""
    for session_id, outputs in processed_sessions.items():
        write_hypothesis_jsons(out_dir, session_id, outputs, text_norm)
        matches = [c for c in references_cs
                   if get_cut_recording_id(c) == session_id]
        if not matches:
            raise ValueError(f"Session {session_id} not found in references")
        gt_cut = matches[0]
        sups = gt_cut.supervisions
        offset = getattr(gt_cut, "start", 0.0) or 0.0
        ref_seglst = supervisions_to_seglst(sups, session_id)
        if offset > 0:
            ref_seglst = ref_seglst.map(
                lambda s: {**s, "start_time": s["start_time"] + offset,
                           "end_time": s["end_time"] + offset})
        ref_seglst = ref_seglst.map(partial(normalize_segment, tn=text_norm))
        ref_seglst.dump(Path(out_dir) / "wer" / session_id / "ref.json")


def _write_prediction_table(processed_sessions: Dict[str, List[dict]],
                            out_dir, text_norm, references_cs,
                            rows_to_log: int = 10) -> None:
    """Compact (session, speaker) -> (label, hypothesis) table next to the
    per-session SegLSTs — the reference's wandb prediction-table
    observability (evaluation.py:37-51) as a plain JSONL artifact."""
    import json

    refs_by_session = {}
    for c in references_cs:
        rid = get_cut_recording_id(c)
        for sup in c.supervisions:
            key = (rid, str(getattr(sup, "speaker", "") or ""))
            refs_by_session.setdefault(key, []).append(
                text_norm(sup.text or ""))
    rows = []
    for session_id in sorted(processed_sessions):
        by_spk: Dict[str, List[str]] = {}
        for seg in sorted(processed_sessions[session_id],
                          key=lambda s: s["start_time"]):
            by_spk.setdefault(str(seg["speaker"]), []).append(
                text_norm(seg["words"]))
        # include reference speakers the hypothesis missed entirely (an
        # all-deletions decode still gets a (label, "") row)
        speakers = set(by_spk) | {spk for (rid, spk) in refs_by_session
                                  if rid == session_id}
        for spk in sorted(speakers):
            if len(rows) >= rows_to_log:
                break
            rows.append({
                "id": len(rows),
                "session_id": session_id,
                "speaker": spk,
                "label_str": " ".join(
                    refs_by_session.get((session_id, spk), [])),
                "hyp_str": " ".join(by_spk.get(spk, []))})
    with open(Path(out_dir) / "eval_predictions.jsonl", "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")


def calculate_wers(processed_sessions, out_dir, metrics_list,
                   save_visualizations=False, collar=5) -> List[dict]:
    rows: List[dict] = []
    for session_id in processed_sessions:
        base = Path(out_dir) / "wer" / session_id
        rows.extend(calc_wer(
            base, base / "tcp_wer_hyp.json", base / "tc_orc_wer_hyp.json",
            base / "ref.json", collar=collar,
            save_visualizations=save_visualizations,
            metrics_list=metrics_list))
    return rows


def compute_longform_metrics(
    predictions: Sequence[np.ndarray],   # per-sample decoded token streams
    label_keys: Sequence[str],           # "cut_id,spk_id" per sample
    dataset,                             # LhotseLongFormDataset
    tokenizer,
    output_dir: str,
    text_norm: Callable[[str], str],
    metrics_list: Optional[List[str]] = None,
    save_visualizations: bool = False,
) -> Dict[str, float]:
    """Rank-0 scoring path (evaluation.py:239-291)."""
    metrics_list = metrics_list or ["tcp_wer"]
    orig_cs = dataset.cset
    references_cs = dataset.references
    cuts_by_id = {c.id: c for c in orig_cs}

    processed: Dict[str, List[dict]] = {}
    seen = set()
    for preds, key in zip(predictions, label_keys):
        cut_id, spk_id = key.split(",")
        if (cut_id, spk_id) in seen:
            continue  # duplicated samples (e.g. padded eval batches)
        seen.add((cut_id, spk_id))
        if cut_id not in cuts_by_id:
            raise KeyError(f"Key {cut_id!r} not found in dataset")
        cut = cuts_by_id[cut_id]
        rid = get_cut_recording_id(cut)
        processed.setdefault(rid, []).extend(process_session(
            preds, tokenizer, spk_id, cut,
            break_to_characters=getattr(dataset, "break_to_characters", False)))

    os.makedirs(output_dir, exist_ok=True)
    save_session_outputs(processed, output_dir, text_norm, references_cs)
    _write_prediction_table(processed, output_dir, text_norm, references_cs)
    rows = calculate_wers(processed, output_dir, metrics_list,
                          save_visualizations=save_visualizations)

    # annotate rows with the session language (per-language aggregation in
    # scripts/compute_overall_statistics.py)
    lang_by_session = {}
    for c in references_cs:
        lang = (c.custom or {}).get("lang") if getattr(c, "custom", None) else None
        if lang:
            lang_by_session[get_cut_recording_id(c)] = lang
    for row in rows:
        if row.get("session_id") in lang_by_session:
            row["language"] = lang_by_session[row["session_id"]]

    # per-session CSV (evaluation.py:286-288)
    csv_path = Path(output_dir) / "all_session_wer.csv"
    if rows:
        keys = sorted({k for row in rows for k in row})
        with open(csv_path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=keys)
            writer.writeheader()
            for row in rows:
                writer.writerow({k: row.get(k) for k in keys})
    return aggregate_wer_metrics(rows, metrics_list)


def compute_shortform_metrics(predictions, labels, tokenizer, text_norm,
                              output_dir: Optional[str] = None,
                              return_texts: bool = False):
    """jiwer-style WER/CER on decoded strings (evaluation.py:32-79),
    implemented with the native levenshtein (jiwer is not a dependency)."""
    import re

    from .native import levenshtein

    def clean(ids):
        ids = np.asarray(ids).copy()
        ids[ids == -100] = tokenizer.pad_token_id
        text = tokenizer.decode(ids, skip_special_tokens=True)
        return text_norm(re.sub(r"\<\|\d+\.\d+\|\>", " ", text)).strip()

    pred_str = [clean(p) for p in predictions]
    label_str = [clean(l) or "-" for l in labels]

    vocab: Dict[str, int] = {}

    def ids_of(words):
        return np.asarray([vocab.setdefault(w, len(vocab)) for w in words],
                          np.int32)

    total_err = total_len = 0
    cer_err = cer_len = 0
    for ref, hyp in zip(label_str, pred_str):
        e, _ = levenshtein(ids_of(ref.split()), ids_of(hyp.split()))
        total_err += e
        total_len += len(ref.split())
        ce, _ = levenshtein(ids_of(list(ref)), ids_of(list(hyp)))
        cer_err += ce
        cer_len += len(ref)
    if output_dir:
        with open(Path(output_dir) / "predictions.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["label", "prediction"])
            w.writerows(zip(label_str, pred_str))
    metrics = {"wer": total_err / max(total_len, 1),
               "cer": cer_err / max(cer_len, 1)}
    if return_texts:
        return metrics, pred_str, label_str
    return metrics
