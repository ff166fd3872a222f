"""STNO (Silence / Target / Non-target / Overlap) mask construction.

Pure-numpy host-side port of the semantics in
the reference's src/data/local_datasets.py:162-194: per-speaker sample-level
activity masks are mean-pooled to the encoder frame rate (50 Hz) and combined
into 4 soft class probabilities per frame for a chosen target speaker.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

SAMPLE_RATE = 16_000
HOP_LENGTH = 160
N_SAMPLES_CHUNK = 30 * SAMPLE_RATE
MODEL_FEATURES_SUBSAMPLE = 2  # mel hop 100 Hz -> encoder 50 Hz


def speakers_audio_mask(
    supervisions: Sequence,
    num_samples: int,
    speaker_to_idx: Dict[str, int],
    sampling_rate: int = SAMPLE_RATE,
) -> np.ndarray:
    """Binary (num_speakers, num_samples) activity mask from supervision
    intervals (equivalent of lhotse Cut.speakers_audio_mask). Supervision
    times are relative to the cut; intervals are clipped to the cut span."""
    mask = np.zeros((len(speaker_to_idx), num_samples), dtype=np.uint8)
    for sup in supervisions:
        spk = getattr(sup, "speaker", None)
        if spk not in speaker_to_idx:
            continue
        start = max(0, int(round(sup.start * sampling_rate)))
        end = min(num_samples, int(round((sup.start + sup.duration) * sampling_rate)))
        if end > start:
            mask[speaker_to_idx[spk], start:end] = 1
    return mask


def downsample_speaker_mask(
    spk_mask: np.ndarray,
    n_samples_chunk: int = N_SAMPLES_CHUNK,
    subsample_factor: int = MODEL_FEATURES_SUBSAMPLE,
    hop_length: int = HOP_LENGTH,
) -> np.ndarray:
    """Pad to a 30 s multiple and mean-pool to the 50 Hz encoder frame rate
    (local_datasets.py:168-174)."""
    pad_len = (-spk_mask.shape[-1]) % n_samples_chunk
    spk_mask = np.pad(spk_mask, ((0, 0), (0, pad_len)), mode="constant")
    window = subsample_factor * hop_length
    return spk_mask.astype(np.float32).reshape(
        spk_mask.shape[0], -1, window).mean(axis=-1)


def create_stno_mask(spk_mask: np.ndarray, s_index: int) -> np.ndarray:
    """(S, T) soft speaker activity -> (T, 4) STNO probabilities
    (local_datasets.py:184-194):

    silence   = prod_s (1 - m_s)
    target    = m_tgt * prod_{s != tgt} (1 - m_s)
    non_target= (1 - m_tgt) * (1 - prod_{s != tgt} (1 - m_s))
    overlap   = m_tgt - target
    """
    non_target_rows = np.ones(spk_mask.shape[0], dtype=bool)
    non_target_rows[s_index] = False
    sil = (1 - spk_mask).prod(axis=0)
    anyone_else = (1 - spk_mask[non_target_rows]).prod(axis=0)
    target = spk_mask[s_index] * anyone_else
    non_target = (1 - spk_mask[s_index]) * (1 - anyone_else)
    overlap = spk_mask[s_index] - target
    return np.stack([sil, target, non_target, overlap], axis=0).T.astype(np.float32)


def get_stno_mask(
    supervisions: Sequence,
    num_samples: int,
    target_speaker: str,
    sampling_rate: int = SAMPLE_RATE,
    speakers: Optional[List[str]] = None,
) -> np.ndarray:
    """Full pipeline for one cut + target speaker (local_datasets.py:162-182).

    ``target_speaker == "-1"`` means "unmapped speaker" (real-diarization
    decode): an all-zero activity row is appended and used as the target.
    """
    if speakers is None:
        speakers = sorted({s.speaker for s in supervisions
                           if getattr(s, "speaker", None) is not None})
    speaker_to_idx = {spk: i for i, spk in enumerate(speakers)}
    spk_mask = speakers_audio_mask(supervisions, num_samples, speaker_to_idx,
                                   sampling_rate)
    spk_mask = downsample_speaker_mask(spk_mask)

    if target_speaker == "-1":
        spk_mask = np.pad(spk_mask, ((0, 1), (0, 0)), mode="constant")
        s_index = -1
    else:
        s_index = speaker_to_idx[target_speaker]
    return create_stno_mask(spk_mask, s_index)


def pad_stno_mask_batch(masks: Sequence[np.ndarray]) -> np.ndarray:
    """Pad (T_i, 4) masks to a common length and transpose to (B, 4, T); the
    padded region is marked silence (collators.py:157-161)."""
    max_t = max(m.shape[0] for m in masks)
    out = np.zeros((len(masks), max_t, 4), dtype=np.float32)
    for i, m in enumerate(masks):
        out[i, : m.shape[0]] = m
        out[i, m.shape[0]:, 0] = 1.0
    return out.transpose(0, 2, 1)
