"""Host-side audio IO: WAV loading + resampling.

The reference leans on lhotse/torchaudio/ffmpeg for audio IO
(the reference's src/data/local_datasets.py:196-214); none of those native
stacks is a dependency here. WAV (PCM 16/24/32, float32) is decoded with the
stdlib + numpy; polyphase resampling via scipy. Other codecs can be plugged
in through ``register_audio_loader``.
"""

from __future__ import annotations

import wave
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import numpy as np

_LOADERS: Dict[str, Callable[[str], Tuple[np.ndarray, int]]] = {}


def register_audio_loader(suffix: str,
                          fn: Callable[[str], Tuple[np.ndarray, int]]) -> None:
    _LOADERS[suffix.lower()] = fn


def load_wav(path: str) -> Tuple[np.ndarray, int]:
    """Returns (samples (channels, n) float32 in [-1, 1], sample_rate)."""
    with wave.open(str(path), "rb") as w:
        n_ch = w.getnchannels()
        width = w.getsampwidth()
        sr = w.getframerate()
        n = w.getnframes()
        raw = w.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 3:
        a = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        signed = (a[:, 0].astype(np.int32)
                  | (a[:, 1].astype(np.int32) << 8)
                  | (a[:, 2].astype(np.int32) << 16))
        signed = np.where(signed >= 1 << 23, signed - (1 << 24), signed)
        data = signed.astype(np.float32) / float(1 << 23)
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"Unsupported WAV sample width {width} in {path}")
    return data.reshape(-1, n_ch).T, sr


def load_audio(path: str,
               offset: float = 0.0,
               duration: Optional[float] = None,
               target_sr: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """Load (channels, n) float32 audio, optionally slicing and resampling."""
    suffix = Path(path).suffix.lower()
    if suffix == ".flac" and suffix not in _LOADERS:
        # first-party native decoder (native/flac.cc) — registered lazily so
        # WAV-only workflows never touch ctypes
        from .flac import load_flac

        register_audio_loader(".flac", load_flac)
    if suffix in _LOADERS:
        samples, sr = _LOADERS[suffix](path)
    elif suffix == ".wav":
        samples, sr = load_wav(path)
    else:
        try:  # scipy handles some extra wav variants (float32 etc.)
            from scipy.io import wavfile

            sr, data = wavfile.read(path)
            if data.dtype == np.int16:
                data = data.astype(np.float32) / 32768.0
            elif data.dtype == np.int32:
                data = data.astype(np.float32) / 2147483648.0
            elif data.dtype != np.float32:
                data = data.astype(np.float32)
            samples = np.atleast_2d(data.T if data.ndim > 1 else data)
        except Exception as e:
            raise ValueError(
                f"No decoder for {path!r}; register one with "
                f"register_audio_loader") from e

    if offset or duration is not None:
        start = int(round(offset * sr))
        end = (start + int(round(duration * sr))
               if duration is not None else samples.shape[1])
        samples = samples[:, start:end]
    if target_sr is not None and target_sr != sr:
        samples = resample(samples, sr, target_sr)
        sr = target_sr
    return samples.astype(np.float32), sr


def resample(samples: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(sr, target_sr)
    return resample_poly(samples, target_sr // g, sr // g,
                         axis=-1).astype(np.float32)


def save_wav(path: str, samples: np.ndarray, sr: int) -> None:
    samples = np.atleast_2d(samples)
    pcm = np.clip(samples.T * 32767.0, -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(samples.shape[0])
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
