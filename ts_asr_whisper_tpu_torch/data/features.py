"""Host log-mel featurizer of the port (numpy, no device code).

A jax-free copy of ts_asr_whisper_tpu/ops/mel.py:32-92, 107-111 and 163-266
(``mel_filter_bank``, ``_mel_filters_np``, ``_hann_window``,
``_whisper_log_tail``, ``_mel_workspace``, ``log_mel_numpy``,
``extract_features`` and the constants they use). That module imports jax at
the top for its device path; fold this copy back once the numpy featurizer
moves out of it.
"""

from __future__ import annotations

import functools
import threading

import numpy as np

SAMPLE_RATE = 16_000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH = 30
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE  # 480_000
FRAMES_PER_CHUNK = N_SAMPLES // HOP_LENGTH  # 3000


def hertz_to_mel_slaney(freq: np.ndarray) -> np.ndarray:
    """Slaney mel scale: linear below 1 kHz, log above."""
    freq = np.asarray(freq, dtype=np.float64)
    min_log_hertz = 1000.0
    min_log_mel = 15.0
    logstep = 27.0 / np.log(6.4)
    mels = 3.0 * freq / 200.0
    log_region = freq >= min_log_hertz
    mels = np.where(log_region,
                    min_log_mel + np.log(np.maximum(freq, min_log_hertz) / min_log_hertz) * logstep,
                    mels)
    return mels


def mel_to_hertz_slaney(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    min_log_mel = 15.0
    logstep = np.log(6.4) / 27.0
    freq = 200.0 * mels / 3.0
    log_region = mels >= min_log_mel
    freq = np.where(log_region, 1000.0 * np.exp(logstep * (mels - min_log_mel)), freq)
    return freq


def mel_filter_bank(num_frequency_bins: int = 1 + N_FFT // 2,
                    num_mel_filters: int = 80,
                    min_frequency: float = 0.0,
                    max_frequency: float = 8000.0,
                    sampling_rate: int = SAMPLE_RATE) -> np.ndarray:
    """Slaney-scale, slaney-normalized triangular mel filter bank.

    Returns (num_frequency_bins, num_mel_filters) float32, matching
    ``transformers.audio_utils.mel_filter_bank(norm='slaney', mel_scale='slaney')``.
    """
    mel_min = hertz_to_mel_slaney(np.array(min_frequency))
    mel_max = hertz_to_mel_slaney(np.array(max_frequency))
    mel_freqs = np.linspace(mel_min, mel_max, num_mel_filters + 2)
    filter_freqs = mel_to_hertz_slaney(mel_freqs)

    fft_freqs = np.linspace(0, sampling_rate // 2, num_frequency_bins)

    filter_diff = np.diff(filter_freqs)
    slopes = np.expand_dims(filter_freqs, 0) - np.expand_dims(fft_freqs, 1)
    down_slopes = -slopes[:, :-2] / filter_diff[:-1]
    up_slopes = slopes[:, 2:] / filter_diff[1:]
    fb = np.maximum(0.0, np.minimum(down_slopes, up_slopes))

    # slaney normalization (area of each filter = const energy)
    enorm = 2.0 / (filter_freqs[2 : num_mel_filters + 2] - filter_freqs[:num_mel_filters])
    fb *= np.expand_dims(enorm, 0)
    return fb.astype(np.float32)




@functools.lru_cache(maxsize=8)
def _mel_filters_np(num_mel_filters: int) -> np.ndarray:
    # cache numpy, NOT jnp: a jnp array created during a jit trace would
    # cache a tracer and leak into later traces
    return mel_filter_bank(num_mel_filters=num_mel_filters)


def _hann_window(dtype=np.float32) -> np.ndarray:
    """Periodic Hann — the single definition shared by the MXU rDFT basis
    (fp64) and the numpy host path (fp32)."""
    t = np.arange(N_FFT, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * t / N_FFT))).astype(dtype)


def _whisper_log_tail(mel, xp):
    """Whisper's log-mel normalization (1e-10 clip, per-sample max-8 floor,
    (x+4)/4 scale) — one definition for the jnp and numpy paths so an
    HF-parity tweak cannot desynchronize train-time from decode-time
    features."""
    log_spec = xp.log10(xp.clip(mel, 1e-10, None))
    max_val = log_spec.max(axis=(1, 2), keepdims=True)
    log_spec = xp.maximum(log_spec, max_val - 8.0)
    return (log_spec + 4.0) / 4.0


_WS = threading.local()


def _mel_workspace(b: int, t: int):
    """Per-thread reusable buffers for log_mel_numpy. Each call otherwise
    allocates ~40 MB of fresh >mmap-threshold blocks, and the page-fault
    churn DOUBLES the featurization cost (measured 17.7 -> 7.8 ms per 30 s
    window on one host core). Thread-local so the threaded dataloader's
    workers never share; process workers fork their own copies."""
    store = getattr(_WS, "buf", None)
    if store is None:
        store = _WS.buf = {}
    key = (b, t)
    ws = store.get(key)
    if ws is None:
        n_freq = N_FFT // 2 + 1
        ws = store[key] = {
            "win": np.empty((b, t, N_FFT), np.float64),
            "p64": np.empty((b, t, n_freq), np.float64),
            "tmp": np.empty((b, t, n_freq), np.float64),
            "p32": np.empty((b, t, n_freq), np.float32),
        }
    return ws


def log_mel_numpy(waveform: np.ndarray, num_mel_filters: int = 80
                  ) -> np.ndarray:
    """Pure-numpy mirror of log_mel_spectrogram for HOST featurization.

    Dataloader workers must never touch the device: the round trip
    serializes the loader on the accelerator and steals device time from
    the train step (round-1 weakness). The FFT releases the GIL, so thread
    workers parallelize. (B, N) fp32 -> (B, n_mels, T); N a multiple of
    N_SAMPLES. Numerics match the jnp path / HF fp32 to ~1e-5.

    fp64 FFT: an fp32 FFT is ~2x faster but costs ~1e-3 absolute error in
    the normalized log-mel — outside the 5e-5 HF-parity budget. scipy's
    pocketfft is ~3.6x faster than numpy's at the same fp64 precision
    (measured 2.0 vs 7.2 ms per 30 s window on one host core — it was the
    single largest cost of the featurization path); together with the
    reused workspace this more than halves the per-window host cost
    (17.7 -> ~8 ms, output identical to ~4e-7)."""
    if waveform.ndim == 1:
        waveform = waveform[None]
    x = np.pad(waveform.astype(np.float32),
               ((0, 0), (N_FFT // 2, N_FFT // 2)), mode="reflect")
    num_frames = waveform.shape[1] // HOP_LENGTH
    frames = np.lib.stride_tricks.sliding_window_view(
        x, N_FFT, axis=1)[:, ::HOP_LENGTH][:, :num_frames]
    ws = _mel_workspace(frames.shape[0], num_frames)
    # fused upcast-multiply straight into the fp64 workspace (the extra
    # window precision vs the old f32 multiply is ~1e-8)
    np.multiply(frames, _hann_window(), out=ws["win"])
    try:
        from scipy.fft import rfft as _rfft
    except ImportError:  # pragma: no cover - scipy ships in this image
        _rfft = np.fft.rfft
    spec = _rfft(ws["win"], axis=-1)
    np.multiply(spec.real, spec.real, out=ws["p64"])
    np.multiply(spec.imag, spec.imag, out=ws["tmp"])
    ws["p64"] += ws["tmp"]
    ws["p32"][:] = ws["p64"]
    mel = ws["p32"] @ _mel_filters_np(num_mel_filters)
    return np.swapaxes(_whisper_log_tail(mel, np), 1, 2)


def extract_features(waveform: np.ndarray, num_mel_filters: int = 80,
                     pad_to_multiple_of: int = N_SAMPLES):
    """Host entry point matching the reference's feature-extractor call
    (local_datasets.py:208-213): pad to a 30 s multiple, return features and
    a MEL-FRAME-level attention mask (HF FE downsamples the sample mask by
    hop_length — generation's seek logic counts mel frames).

    Runs the numpy mel (no device round trip — this is called from
    dataloader workers). Returns (features (n_mels, T), attention_mask (T,)).
    """
    waveform = np.asarray(waveform, dtype=np.float32).reshape(-1)
    n = waveform.shape[0]
    padded_len = int(np.ceil(max(n, 1) / pad_to_multiple_of)) * pad_to_multiple_of
    padded = np.zeros(padded_len, dtype=np.float32)
    padded[:n] = waveform
    sample_mask = np.zeros(padded_len, dtype=np.int32)
    sample_mask[:n] = 1
    attention_mask = sample_mask[::HOP_LENGTH]
    feats = log_mel_numpy(padded[None], num_mel_filters)[0]
    return feats, attention_mask
