"""Data augmentations (host-side, numpy/scipy).

Ports the semantics of the reference's src/data/augmentations.py — ESPnet
SpecAug (bicubic time warp, freq masks, ratio-width time masks), MUSAN
background noise, speed perturbation — without torch/torchaudio/sox. These
run in dataloader workers; the device path never sees them.
"""

from __future__ import annotations

import random
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np


def _cubic_conv_weights(frac: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Cubic-convolution kernel weights for taps at offsets (-1, 0, 1, 2)
    around the floor sample (the torch/OpenCV bicubic kernel, a=-0.75)."""
    d = np.stack([frac + 1.0, frac, 1.0 - frac, 2.0 - frac], axis=-1)
    d = np.abs(d)
    near = (a + 2.0) * d**3 - (a + 3.0) * d**2 + 1.0
    far = a * d**3 - 5.0 * a * d**2 + 8.0 * a * d - 4.0 * a
    return np.where(d <= 1.0, near, np.where(d < 2.0, far, 0.0))


def _interp_time_bicubic(x: np.ndarray, new_len: int) -> np.ndarray:
    """Resize (T, F) -> (new_len, F) along time with bicubic interpolation —
    torch ``F.interpolate(mode='bicubic', align_corners=False)`` semantics
    (cubic convolution a=-0.75, half-pixel centers, edge clamping), computed
    as one 4-tap gather + weighted sum. ~100x faster than the scipy spline
    zoom it replaces (the round-1 loader bottleneck) and, unlike it,
    parity-testable against torch (tests/test_augmentations.py)."""
    t = x.shape[0]
    if t == new_len:
        return x
    src = (np.arange(new_len, dtype=np.float64) + 0.5) * (t / new_len) - 0.5
    i0 = np.floor(src).astype(np.int64)
    frac = src - i0
    taps = np.clip(i0[:, None] + np.arange(-1, 3)[None, :], 0, t - 1)
    w = _cubic_conv_weights(frac).astype(x.dtype)        # (new_len, 4)
    return np.einsum("ok,okf->of", w, x[taps])


def time_warp(x: np.ndarray, window: int = 5) -> np.ndarray:
    """ESPnet TimeWarp (augmentations.py:123-162): pick a center in
    [window, T-window), interpolate the two halves to a warped split."""
    t = x.shape[0]
    if t - window <= window:
        return x
    center = random.randrange(window, t - window)
    warped = random.randrange(center - window, center + window) + 1
    left = _interp_time_bicubic(x[:center], warped)
    right = _interp_time_bicubic(x[center:], t - warped)
    return np.concatenate([left, right], axis=0)


def mask_along_axis(x: np.ndarray, dim: int, num_masks: int,
                    width_range: Tuple[int, int]) -> np.ndarray:
    """ESPnet MaskAlongAxis (augmentations.py:165-219), mask value 0."""
    size = x.shape[dim]
    widths = np.random.randint(width_range[0], width_range[1] + 1, num_masks)
    for w in widths:
        if w == 0 or size - w <= 0:
            continue
        start = np.random.randint(0, size - w)
        sl = [slice(None)] * x.ndim
        sl[dim] = slice(start, start + w)
        x[tuple(sl)] = 0.0
    return x


class SpecAug:
    """ESPnet-style SpecAug (augmentations.py:295-379). Operates on
    (B, T, F) float arrays in place-ish (returns new array)."""

    def __init__(self, apply_time_warp=True, time_warp_window=5,
                 time_warp_mode="bicubic", apply_freq_mask=True,
                 freq_mask_width_range=(0, 27), num_freq_mask=2,
                 apply_time_mask=True, time_mask_width_ratio_range=(0.0, 0.05),
                 num_time_mask=5):
        self.apply_time_warp = apply_time_warp
        self.time_warp_window = time_warp_window
        self.apply_freq_mask = apply_freq_mask
        self.freq_mask_width_range = tuple(freq_mask_width_range)
        self.num_freq_mask = num_freq_mask
        self.apply_time_mask = apply_time_mask
        self.time_mask_width_ratio_range = tuple(time_mask_width_ratio_range)
        self.num_time_mask = num_time_mask

    def __call__(self, x: np.ndarray) -> np.ndarray:
        x = np.array(x, dtype=np.float32, copy=True)
        b, t, f = x.shape
        if self.apply_time_warp:
            for i in range(b):
                x[i] = time_warp(x[i], self.time_warp_window)
        if self.apply_freq_mask:
            for i in range(b):
                x[i] = mask_along_axis(x[i], dim=1,
                                       num_masks=self.num_freq_mask,
                                       width_range=self.freq_mask_width_range)
        if self.apply_time_mask:
            lo = int(self.time_mask_width_ratio_range[0] * t)
            hi = max(int(self.time_mask_width_ratio_range[1] * t), lo)
            for i in range(b):
                x[i] = mask_along_axis(x[i], dim=0,
                                       num_masks=self.num_time_mask,
                                       width_range=(lo, hi))
        return x


class RandomBackgroundNoise:
    """MUSAN-style additive noise at SNR 0-15 dB (augmentations.py:382-429)."""

    def __init__(self, sample_rate: int, noise_dir: str,
                 min_snr_db: float = 0.0, max_snr_db: float = 15.0):
        self.sample_rate = sample_rate
        self.min_snr_db = min_snr_db
        self.max_snr_db = max_snr_db
        root = Path(noise_dir)
        self.noise_files = sorted(root.rglob("*.wav")) if root.exists() else []
        if not self.noise_files:
            raise IOError(f"No .wav files found in noise dir {noise_dir}")

    def __call__(self, audio: np.ndarray) -> np.ndarray:
        from .audio import load_audio

        audio = np.asarray(audio, dtype=np.float32).reshape(-1)
        n = len(audio)
        path = random.choice(self.noise_files)
        noise, _ = load_audio(str(path), target_sr=self.sample_rate)
        noise = noise.reshape(-1)
        if len(noise) < n:
            reps = int(np.ceil(n / max(len(noise), 1)))
            noise = np.tile(noise, reps)
        start = random.randrange(0, len(noise) - n + 1)
        noise = noise[start : start + n]
        snr_db = random.uniform(self.min_snr_db, self.max_snr_db)
        speech_rms = np.sqrt(np.mean(audio**2) + 1e-10)
        noise_rms = np.sqrt(np.mean(noise**2) + 1e-10)
        snr = 10 ** (snr_db / 20.0)
        scale = speech_rms / (snr * noise_rms)
        return audio + scale * noise


def speed_perturb(audio: np.ndarray, sample_rate: int,
                  factors: Sequence[float] = (0.9, 1.0, 1.1)) -> np.ndarray:
    """Sox-style speed change via resampling (augmentations.py:432-448)."""
    from .audio import resample

    factor = random.choice(list(factors))
    if factor == 1.0:
        return audio
    return resample(np.atleast_2d(audio), int(sample_rate * factor),
                    sample_rate).reshape(-1)


# ---------------------------------------------------------------------------
# STNO-mask augmentations (collators.py:50-138)
# ---------------------------------------------------------------------------


def stno_gaussian_noise(prob_mask: np.ndarray, variance: float = 0.05,
                        fraction: float = 0.5) -> np.ndarray:
    """Add Gaussian noise to a random subset of batch STNO masks, shift to
    non-negative, renormalize over the class axis (collators.py:50-78)."""
    b, c, t = prob_mask.shape
    num_noisy = int(b * fraction)
    if num_noisy == 0:
        return prob_mask
    idx = np.random.permutation(b)[:num_noisy]
    out = prob_mask.copy()
    noise = np.random.randn(num_noisy, c, t).astype(prob_mask.dtype) \
        * (variance ** 0.5)
    out[idx] += noise
    mins = np.clip(out[idx].min(axis=1, keepdims=True), None, 0)
    out[idx] -= mins
    out[idx] /= out[idx].sum(axis=1, keepdims=True)
    return out


def stno_soft_segment_augment(stno_mask: np.ndarray, change_prob: float = 0.2,
                              min_seg_len: int = 5,
                              max_seg_len: int = 20) -> np.ndarray:
    """Softly flip random segments to a different dominant class
    (collators.py:80-138): simulates diarization errors."""
    b, c, t = stno_mask.shape
    out = stno_mask.copy()
    for i in range(b):
        pos = 0
        while pos < t:
            seg_len = np.random.randint(min_seg_len, max_seg_len + 1)
            end = min(pos + seg_len, t)
            if np.random.rand() < change_prob:
                seg = out[i, :, pos:end]
                dominant = int(seg.mean(axis=1).argmax())
                choices = [k for k in range(c) if k != dominant]
                if choices:
                    target = choices[np.random.randint(len(choices))]
                    target_dist = np.zeros_like(seg)
                    target_dist[target, :] = 1.0
                    softness = np.random.rand()
                    new_seg = (1 - softness) * seg + softness * target_dist
                    out[i, :, pos:end] = new_seg / new_seg.sum(axis=0,
                                                               keepdims=True)
            pos = end
    return out
