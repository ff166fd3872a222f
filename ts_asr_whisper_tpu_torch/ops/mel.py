"""Whisper log-mel on the device of the port.

Counterpart of ts_asr_whisper_tpu/ops/mel.py:94-160 (``_dft_kernel``,
``_frame``, ``power_spectrogram``, ``log_mel_spectrogram``): polyphase
framing by reshapes, the Hann-windowed real DFT as one (B * T, 400) x
(400, 402) product, the power spectrum, the mel projection and Whisper's log
tail, all on the device the waveform is on. The filter bank, the window and
the log tail are those of the host featurizer (data/features.py), so the
two cannot drift apart.

Precision: the DFT product and the power spectrum run in fp64, as the host
featurizer's FFT does; the rest is fp32 with TF32 off. An fp32 DFT product
(the JAX package's, at ``Precision.HIGHEST``) puts up to ~5e-5 of error into
the normalized log-mel of a low-power bin, the whole of the 5e-5 budget of
tests/test_mel.py; in fp64 the device log-mel is within ~1e-5 of the host
featurizer's (the fp32 mel projection's summation order).

Tooling reads it (the JAX package's bench.py:77 and
scripts/profile_decode.py:77 featurize on the device); the decode path keeps
the host featurizer.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..data.features import (HOP_LENGTH, N_FFT, _hann_window,
                             _mel_filters_np, _whisper_log_tail)


@functools.lru_cache(maxsize=1)
def _dft_basis() -> np.ndarray:
    """Hann-windowed real-DFT basis in fp64, (N_FFT, 2 * n_freq): columns
    [cos_0..cos_200, sin_0..sin_200], the window folded in (the JAX
    package's ``_dft_kernel`` before its cast to fp32)."""
    n_freq = 1 + N_FFT // 2
    t = np.arange(N_FFT, dtype=np.float64)
    k = np.arange(n_freq, dtype=np.float64)
    angle = 2.0 * np.pi * np.outer(t, k) / N_FFT
    window = _hann_window(np.float64)
    cos_b = np.cos(angle) * window[:, None]
    sin_b = -np.sin(angle) * window[:, None]
    return np.concatenate([cos_b, sin_b], axis=1)


@contextlib.contextmanager
def _no_tf32():
    """fp32 products stay fp32 on the card within the block."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class _NumpyMax(torch.Tensor):
    """A tensor whose ``max`` takes numpy's ``axis`` tuple and
    ``keepdims``, so that data/features.py::_whisper_log_tail runs on it
    with ``xp=torch``."""

    def max(self, axis=None, keepdims=False):
        return torch.amax(self, dim=axis, keepdim=keepdims)


def _frame(x: torch.Tensor, num_frames: int) -> torch.Tensor:
    """Polyphase framing: (B, L) -> (B, num_frames, N_FFT) frames at stride
    HOP_LENGTH from reshapes, slices and one concatenation (N_FFT =
    2 * HOP + HOP / 2)."""
    b, n = x.shape
    need = (num_frames + 2) * HOP_LENGTH + HOP_LENGTH - n
    if need > 0:
        x = F.pad(x, (0, need))
    hops = x.reshape(b, -1, HOP_LENGTH)
    f0 = hops[:, :num_frames]
    f1 = hops[:, 1: num_frames + 1]
    f2 = hops[:, 2: num_frames + 2, : N_FFT - 2 * HOP_LENGTH]
    return torch.cat([f0, f1, f2], dim=-1)


def power_spectrogram(waveform: torch.Tensor) -> torch.Tensor:
    """(B, N) waveform -> (B, T, n_freq) fp32 power spectrum, torch.stft-
    compatible: reflect pad of N_FFT // 2 on both sides (center=True), the
    last frame dropped. The fp32 frames go through the fp64 basis."""
    n_freq = 1 + N_FFT // 2
    pad = N_FFT // 2
    x = F.pad(waveform.float(), (pad, pad), mode="reflect")
    frames = _frame(x, waveform.shape[1] // HOP_LENGTH)
    basis = torch.as_tensor(_dft_basis(), device=waveform.device)
    out = torch.matmul(frames.double(), basis)
    re, im = out[..., :n_freq], out[..., n_freq:]
    return (re * re + im * im).float()


def log_mel_spectrogram(waveform: torch.Tensor,
                        num_mel_filters: int = 80) -> torch.Tensor:
    """(B, N) (or (N,)) fp32 waveform -> (B, n_mels, T) Whisper log-mel
    features on the waveform's device. N is a multiple of N_SAMPLES (the
    host pads to 30 s multiples)."""
    if waveform.ndim == 1:
        waveform = waveform[None]
    power = power_spectrogram(waveform)
    filters = torch.as_tensor(_mel_filters_np(num_mel_filters),
                              device=waveform.device)
    with _no_tf32():
        mel = torch.matmul(power, filters)
    logmel = _whisper_log_tail(mel.as_subclass(_NumpyMax), torch)
    return logmel.as_subclass(torch.Tensor).transpose(1, 2)
