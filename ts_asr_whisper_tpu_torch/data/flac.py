"""FLAC decoding via the native decoder (native/flac.cc, ctypes).

The reference reads FLAC corpora (LibriSpeech/Libri2Mix ship FLAC) through
lhotse's torchaudio/ffmpeg backends (the reference's src/data/
local_datasets.py:196-214); here the codec is first-party native code so
the data layer stays dependency-free. ``load_flac`` plugs into
``data.audio.load_audio`` automatically (audio.py registers it lazily for
the ``.flac`` suffix). Round-trip-validated against an independent
pure-Python encoder (tests/flac_writer.py) across subframe types, Rice
partitionings, stereo decorrelation modes, and bit depths.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from ..eval.native import _load

_FLAC_BOUND = False


def _bind(lib):
    """Type the FLAC entry points of the native library (built from
    native/tclev.cc and native/flac.cc together, so it always has them)."""
    global _FLAC_BOUND
    if not _FLAC_BOUND:
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.flac_stream_info.restype = ctypes.c_int
        lib.flac_stream_info.argtypes = [
            u8p, ctypes.c_long, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_long)]
        lib.flac_decode.restype = ctypes.c_long
        lib.flac_decode.argtypes = [u8p, ctypes.c_long, i32p, ctypes.c_long]
        _FLAC_BOUND = True
    return lib


def decode_flac_bytes(data: bytes) -> Tuple[np.ndarray, int, int]:
    """Returns (samples (channels, n) int32 at the stream bit depth,
    sample_rate, bits_per_sample)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "native FLAC decoder unavailable (no C++ compiler built "
            "native/flac.cc)")
    lib = _bind(lib)
    buf = np.frombuffer(data, dtype=np.uint8)
    sr = ctypes.c_int()
    ch = ctypes.c_int()
    bps = ctypes.c_int()
    total = ctypes.c_long()
    rc = lib.flac_stream_info(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(buf),
        ctypes.byref(sr), ctypes.byref(ch), ctypes.byref(bps),
        ctypes.byref(total))
    if rc != 0:
        raise ValueError("not a FLAC stream (bad STREAMINFO)")
    # total_samples may legitimately be 0 (unknown, e.g. piped encodes);
    # highly compressible audio can exceed any size-based guess, so grow
    # the buffer on the decoder's capacity signal (-2) until it fits.
    # The retry cap is stream-derived, not a fixed 2^34: each decoded
    # frame starts with a 14-bit sync (0xFF 0xF8..0xFB upper bits) and
    # carries at most 32768 samples/channel, so (#sync-byte-pairs + 1) *
    # 32768 bounds the decodable sample count — a corrupt/crafted file
    # cannot drive multi-GiB allocations past what its own frame count
    # could ever produce.
    syncs = int(np.count_nonzero(
        (buf[:-1] == 0xFF) & ((buf[1:] & 0xFC) == 0xF8)))
    n_cap = min((syncs + 1) * 32768, 1 << 34)
    n_guess = total.value if total.value else \
        min((4 * len(data) * 8) // max(bps.value, 1) + 65536, n_cap)
    while True:
        out = np.empty(n_guess * ch.value, dtype=np.int32)
        done = lib.flac_decode(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(buf),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), out.size)
        if done == -2 and n_guess < n_cap:
            n_guess = min(n_guess * 4, n_cap)
            continue
        break
    if done < 0:
        raise ValueError("corrupt or unsupported FLAC stream")
    samples = out[: done * ch.value].reshape(done, ch.value).T
    return samples, sr.value, bps.value


def load_flac(path: str) -> Tuple[np.ndarray, int]:
    """``load_audio`` plugin: (channels, n) float32 in [-1, 1] + rate."""
    with open(path, "rb") as f:
        data = f.read()
    samples, sr, bps = decode_flac_bytes(data)
    scale = float(1 << (bps - 1))
    return samples.astype(np.float32) / scale, sr
