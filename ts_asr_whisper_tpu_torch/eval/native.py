"""ctypes binding for the native WER matchers (native/tclev.cc), with a
numpy fallback for a machine without a C++ compiler.

Unlike the JAX package's copy, which runs ``make -C native``, the library is
built here directly from ``native/tclev.cc`` and ``native/flac.cc`` into
``build/native/<source hash>/``, with the first compiler that builds it
with OpenMP: ``$CXX``, then ``/usr/bin/g++``, ``g++`` and ``c++`` (a
toolchain without ``libgomp.spec`` fails the ``-fopenmp`` link and the next
one is tried)."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_SOURCES = ("tclev.cc", "flac.cc")
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
_CXXFLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-fopenmp")
_lib: Optional[ctypes.CDLL] = None
_tried_build = False
# the compiler that built the library, or the failures of every candidate
build_log: List[str] = []


def _compilers() -> List[str]:
    out: List[str] = []
    for cand in (os.environ.get("CXX"), "/usr/bin/g++", "g++", "c++"):
        path = shutil.which(cand) if cand else None
        if path and path not in out:
            out.append(path)
    return out


def build_library() -> Optional[Path]:
    """Compile the matchers and the FLAC decoder into one shared library
    unless a build of the same sources exists; None if no compiler can."""
    srcs = [_NATIVE_DIR / name for name in _SOURCES]
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in srcs)
                            + " ".join(_CXXFLAGS).encode()).hexdigest()[:16]
    lib = _BUILD_ROOT / digest / "libtsaw_native.so"
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.parent / f".libtsaw_native.{os.getpid()}.so"
    for cxx in _compilers():
        proc = subprocess.run([cxx, *_CXXFLAGS, "-o", str(tmp),
                               *map(str, srcs)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode == 0:
            os.replace(tmp, lib)  # atomic: a concurrent build sees all or none
            build_log.append(f"built with {cxx}")
            return lib
        build_log.append(f"{cxx} failed: {proc.stderr.strip()[-500:]}")
    return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried_build
    if _lib is not None or _tried_build:
        return _lib
    _tried_build = True
    path = build_library()
    if path is not None:
        lib = ctypes.CDLL(str(path))
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.levenshtein.restype = ctypes.c_int64
        lib.levenshtein.argtypes = [i32p, ctypes.c_int64, i32p,
                                    ctypes.c_int64, i32p]
        lib.time_constrained_levenshtein.restype = ctypes.c_int64
        lib.time_constrained_levenshtein.argtypes = [
            i32p, f64p, f64p, ctypes.c_int64,
            i32p, f64p, f64p, ctypes.c_int64,
            ctypes.c_double, i32p]
        lib.pairwise_tclev.restype = None
        lib.pairwise_tclev.argtypes = [
            i32p, f64p, f64p, i64p, ctypes.c_int64,
            i32p, f64p, f64p, i64p, ctypes.c_int64,
            ctypes.c_double, i64p]
        _lib = lib
    return _lib


def _p(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def levenshtein(ref: np.ndarray, hyp: np.ndarray) -> Tuple[int, dict]:
    """Word-id Levenshtein. Returns (errors, {insertions, deletions,
    substitutions})."""
    ref = np.ascontiguousarray(ref, dtype=np.int32)
    hyp = np.ascontiguousarray(hyp, dtype=np.int32)
    lib = _load()
    if lib is not None:
        counts = np.zeros(3, dtype=np.int32)
        err = lib.levenshtein(_p(ref, ctypes.c_int32), len(ref),
                              _p(hyp, ctypes.c_int32), len(hyp),
                              _p(counts, ctypes.c_int32))
        return int(err), {"insertions": int(counts[0]),
                          "deletions": int(counts[1]),
                          "substitutions": int(counts[2])}
    return _py_tclev(ref, None, None, hyp, None, None, collar=None)


def time_constrained_levenshtein(
    ref: np.ndarray, ref_begin: np.ndarray, ref_end: np.ndarray,
    hyp: np.ndarray, hyp_begin: np.ndarray, hyp_end: np.ndarray,
    collar: float,
) -> Tuple[int, dict]:
    ref = np.ascontiguousarray(ref, dtype=np.int32)
    hyp = np.ascontiguousarray(hyp, dtype=np.int32)
    rb = np.ascontiguousarray(ref_begin, dtype=np.float64)
    re_ = np.ascontiguousarray(ref_end, dtype=np.float64)
    hb = np.ascontiguousarray(hyp_begin, dtype=np.float64)
    he = np.ascontiguousarray(hyp_end, dtype=np.float64)
    lib = _load()
    if lib is not None:
        counts = np.zeros(3, dtype=np.int32)
        err = lib.time_constrained_levenshtein(
            _p(ref, ctypes.c_int32), _p(rb, ctypes.c_double),
            _p(re_, ctypes.c_double), len(ref),
            _p(hyp, ctypes.c_int32), _p(hb, ctypes.c_double),
            _p(he, ctypes.c_double), len(hyp),
            float(collar), _p(counts, ctypes.c_int32))
        return int(err), {"insertions": int(counts[0]),
                          "deletions": int(counts[1]),
                          "substitutions": int(counts[2])}
    return _py_tclev(ref, rb, re_, hyp, hb, he, collar)


def _py_tclev(ref, rb, re_, hyp, hb, he, collar):
    """Numpy fallback (slow; used only when the .so is unavailable)."""
    n, m = len(ref), len(hyp)
    INF = 1 << 40
    cost = np.zeros((n + 1, m + 1), dtype=np.int64)
    ins = np.zeros_like(cost)
    dele = np.zeros_like(cost)
    sub = np.zeros_like(cost)
    cost[0, :] = np.arange(m + 1)
    ins[0, :] = np.arange(m + 1)
    cost[:, 0] = np.arange(n + 1)
    dele[:, 0] = np.arange(n + 1)
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            cands = [(cost[i - 1, j] + 1, ins[i - 1, j], dele[i - 1, j] + 1,
                      sub[i - 1, j]),
                     (cost[i, j - 1] + 1, ins[i, j - 1] + 1, dele[i, j - 1],
                      sub[i, j - 1])]
            allowed = True
            if collar is not None and rb is not None:
                allowed = (hb[j - 1] - collar <= re_[i - 1]
                           and he[j - 1] + collar >= rb[i - 1])
            if allowed:
                match = ref[i - 1] == hyp[j - 1]
                cands.append((cost[i - 1, j - 1] + (0 if match else 1),
                              ins[i - 1, j - 1], dele[i - 1, j - 1],
                              sub[i - 1, j - 1] + (0 if match else 1)))
                if match:
                    # prefer diagonal match on ties (same as native)
                    best = min(cands, key=lambda c: (c[0], c is not cands[-1]))
                else:
                    best = min(cands, key=lambda c: c[0])
            else:
                best = min(cands, key=lambda c: c[0])
            cost[i, j], ins[i, j], dele[i, j], sub[i, j] = best
    return int(cost[n, m]), {"insertions": int(ins[n, m]),
                             "deletions": int(dele[n, m]),
                             "substitutions": int(sub[n, m])}


def pairwise_tclev_matrix(ref_streams, hyp_streams, collar: float) -> np.ndarray:
    """Distance matrix between ref and hyp word streams.

    Each stream: (word_ids int32, begin f64, end f64). Uses the native
    batched kernel when available."""
    n_ref, n_hyp = len(ref_streams), len(hyp_streams)
    lib = _load()
    out = np.zeros((n_ref, n_hyp), dtype=np.int64)
    if lib is not None and n_ref and n_hyp:
        def flat(streams):
            words = np.concatenate([np.asarray(s[0], np.int32)
                                    for s in streams]) if streams else \
                np.zeros(0, np.int32)
            begin = np.concatenate([np.asarray(s[1], np.float64)
                                    for s in streams]) if streams else \
                np.zeros(0, np.float64)
            end = np.concatenate([np.asarray(s[2], np.float64)
                                  for s in streams]) if streams else \
                np.zeros(0, np.float64)
            offs = np.zeros(len(streams) + 1, dtype=np.int64)
            np.cumsum([len(s[0]) for s in streams], out=offs[1:])
            return (np.ascontiguousarray(words), np.ascontiguousarray(begin),
                    np.ascontiguousarray(end), offs)

        rw, rb, re_, ro = flat(ref_streams)
        hw, hb, he, ho = flat(hyp_streams)
        lib.pairwise_tclev(
            _p(rw, ctypes.c_int32), _p(rb, ctypes.c_double),
            _p(re_, ctypes.c_double), _p(ro, ctypes.c_int64), n_ref,
            _p(hw, ctypes.c_int32), _p(hb, ctypes.c_double),
            _p(he, ctypes.c_double), _p(ho, ctypes.c_int64), n_hyp,
            float(collar), _p(out, ctypes.c_int64))
        return out
    for r in range(n_ref):
        for h in range(n_hyp):
            err, _ = time_constrained_levenshtein(
                ref_streams[r][0], ref_streams[r][1], ref_streams[r][2],
                hyp_streams[h][0], hyp_streams[h][1], hyp_streams[h][2],
                collar)
            out[r, h] = err
    return out
