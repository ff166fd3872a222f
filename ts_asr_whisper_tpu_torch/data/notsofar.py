"""NOTSOFAR-1 meeting-directory loader.

Port of the reference's load_data (the reference's src/utils/wer_utils.py:
220-333): walks ``<meetings_dir>/<meeting>/`` dirs containing
``devices.json``, ``gt_transcription.json`` and ``gt_meeting_metadata.json``
and returns per-session / per-utterance / per-meeting DataFrames. Inference
runs independently per session (device); close-talk devices are excluded
unless explicitly requested (training supervision only).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import pandas as pd


def _process_query(session_query: str):
    # "query_string ### first_n" convention
    if "###" in session_query:
        query, n = session_query.split("###")
        return query.strip(), int(n)
    return session_query, None


def concat_close_talk_segments(devices_df: pd.DataFrame,
                               gt_utt_df: pd.DataFrame,
                               meeting_dir: Path,
                               out_dir: str,
                               gap_sec: float = 0.0):
    """Close-talk supervision prep (reference wer_utils.py:352-402): for each
    close-talk wav, keep only its GT utterance spans, concatenate them (with
    ``gap_sec`` of silence between spans) into a new wav under
    ``<out_dir>/concat_close_talk/<meeting>/``, and shift the utterance
    start/end/word timings in ``gt_utt_df`` (edited in place) onto the
    concatenated timeline. Returns the new wav paths."""
    from .audio import load_audio, save_wav

    meeting_id = devices_df.meeting_id.unique().item()
    assert gt_utt_df.meeting_id.unique().item() == meeting_id

    new_paths = []
    for wav_name in devices_df["wav_file_names"]:
        utts = gt_utt_df[gt_utt_df["ct_wav_file_name"] == wav_name]
        assert utts.start_time.is_monotonic_increasing
        samples, sr = load_audio(str(meeting_dir / wav_name))
        if samples.ndim == 2:  # (channels, n) -> close-talk mics are mono
            samples = samples[0]
        gap = np.zeros(int(gap_sec * sr), dtype=samples.dtype)

        pieces = []
        t_out = 0.0
        for idx, utt in utts.iterrows():
            span = samples[int(utt.start_time * sr): int(utt.end_time * sr)]
            pieces.append(span)
            pieces.append(gap)
            shift = t_out - utt.start_time
            gt_utt_df.at[idx, "start_time"] = utt.start_time + shift
            gt_utt_df.at[idx, "end_time"] = utt.end_time + shift
            if "word_timing" in gt_utt_df.columns:
                gt_utt_df.at[idx, "word_timing"] = [
                    [w, s + shift, e + shift] for w, s, e in utt.word_timing]
            t_out += utt.end_time - utt.start_time + gap_sec

        out_path = Path(out_dir) / "concat_close_talk" / meeting_id / wav_name
        out_path.parent.mkdir(parents=True, exist_ok=True)
        save_wav(str(out_path), np.concatenate(pieces) if pieces
                 else samples[:0], sr)
        new_paths.append(str(out_path))
    return new_paths


def load_data(meetings_dir: str, session_query: Optional[str] = None,
              return_close_talk: bool = False,
              out_dir: Optional[str] = None
              ) -> Tuple[pd.DataFrame, Optional[pd.DataFrame],
                         Optional[pd.DataFrame]]:
    meetings_dir = Path(meetings_dir)
    gt_utt_dfs, session_dfs, metadata_dfs = [], [], []

    for meeting_subdir in sorted(meetings_dir.glob("*/")):
        if not meeting_subdir.is_dir():
            continue
        transcription_file = meeting_subdir / "gt_transcription.json"
        devices_file = meeting_subdir / "devices.json"
        metadata_file = meeting_subdir / "gt_meeting_metadata.json"

        gt_utt_df = None
        if transcription_file.exists():
            gt_utt_df = pd.read_json(transcription_file)
            gt_utt_df["meeting_id"] = meeting_subdir.name
            gt_utt_dfs.append(gt_utt_df)
        if metadata_file.exists():
            with open(metadata_file) as f:
                metadata_dfs.append(pd.DataFrame([json.load(f)]))

        devices_df = pd.read_json(devices_file)
        devices_df["meeting_id"] = meeting_subdir.name
        if return_close_talk:
            devices_df = devices_df[devices_df.is_close_talk].copy()
            assert len(devices_df) > 0, "no close-talk devices found"
            assert gt_utt_df is not None, "expecting GT transcription"
            if out_dir:
                # concatenate GT speech spans per close-talk mic and retime
                # the GT onto the new timeline (wer_utils.py:284-296)
                wavs = concat_close_talk_segments(
                    devices_df, gt_utt_df, meeting_subdir, out_dir)
            else:
                wavs = [str(meeting_subdir / f.strip())
                        for x in devices_df["wav_file_names"]
                        for f in str(x).split(",")]
            devices_df = devices_df.iloc[0:1].copy()
            devices_df["device_name"] = "close_talk"
            devices_df["session_id"] = "close_talk/" + meeting_subdir.name
            devices_df["wav_file_names"] = [wavs]
        else:
            devices_df = devices_df[~devices_df.is_close_talk].copy()
            prefix = devices_df.is_mc.map(
                {True: "multichannel", False: "singlechannel"})
            devices_df["session_id"] = (prefix + "/" + meeting_subdir.name
                                        + "_" + devices_df["device_name"])
            devices_df["wav_file_names"] = devices_df["wav_file_names"].apply(
                lambda x: [str(meeting_subdir / f.strip())
                           for f in str(x).split(",")])
        session_dfs.append(devices_df)

    all_gt_utt_df = (pd.concat(gt_utt_dfs, ignore_index=True)
                     if gt_utt_dfs else None)
    all_session_df = pd.concat(session_dfs, ignore_index=True)
    all_metadata_df = (pd.concat(metadata_dfs, ignore_index=True)
                       if metadata_dfs else None)

    if all_metadata_df is not None and "MtgType" in all_metadata_df:
        merged = all_session_df.merge(
            all_metadata_df[["meeting_id", "MtgType"]], on="meeting_id",
            how="inner")
        assert len(merged) == len(all_session_df)
        assert not merged.MtgType.str.startswith("read").any(), (
            '"read" meetings are debug-only')
        all_session_df = merged.drop("MtgType", axis=1)

    if session_query:
        query, first_n = _process_query(session_query)
        all_session_df = all_session_df.query(query)
        if first_n:
            all_session_df = all_session_df.head(first_n)

    return all_session_df, all_gt_utt_df, all_metadata_df


def sessions_to_cutset(all_session_df: pd.DataFrame,
                       gt_utt_df: Optional[pd.DataFrame] = None):
    """Convenience: NOTSOFAR sessions -> our CutSet (single-channel wavs),
    attaching GT utterances as supervisions when available."""
    from .audio import load_audio
    from .manifests import CutSet, MonoCut, Recording, AudioSource, \
        SupervisionSegment

    cuts = []
    for _, row in all_session_df.iterrows():
        wavs = row["wav_file_names"]
        path = wavs[0] if isinstance(wavs, (list, tuple)) else str(wavs)
        try:
            samples, sr = load_audio(path)
            num_samples = samples.shape[-1]
        except Exception:
            sr, num_samples = 16000, 0
        rec = Recording(id=row["session_id"],
                        sources=[AudioSource("file", [0], path)],
                        sampling_rate=sr, num_samples=num_samples,
                        duration=num_samples / sr if sr else 0.0)
        sups = []
        if gt_utt_df is not None:
            utts = gt_utt_df[gt_utt_df.meeting_id == row["meeting_id"]]
            for j, utt in utts.iterrows():
                sups.append(SupervisionSegment(
                    id=f"{row['session_id']}-{j}",
                    recording_id=rec.id,
                    start=float(utt.get("start_time", 0.0)),
                    duration=float(utt.get("end_time", 0.0))
                    - float(utt.get("start_time", 0.0)),
                    text=str(utt.get("text", "")),
                    speaker=str(utt.get("speaker_id", "spk"))))
        cuts.append(MonoCut(id=row["session_id"], start=0.0,
                            duration=rec.duration, channel=0, recording=rec,
                            supervisions=sups))
    return CutSet(cuts)
