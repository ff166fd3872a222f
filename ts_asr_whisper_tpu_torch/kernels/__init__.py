"""Hand-written CUDA kernels for Hopper (sm_90a), built with ``nvcc`` at first
use and bound through ``ctypes``.

Each source under ``csrc/`` exposes a plain C function (no PyTorch headers,
so ``nvcc`` builds it in seconds). The shared library lands in
``build/kernels/<name>-<hash of the source>/`` at the repository root, so an
edited source is rebuilt and a checkout builds everything it needs from its
own files. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# the ``dtype`` argument of every C entry point
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# kernel name -> the csrc/<source>.cu that holds it
KERNEL_SOURCES: Dict[str, str] = {
    "flash_attn_fwd": "flash_attn_fwd", "flash_attn_bwd": "flash_attn_bwd",
    "ancestry_attn": "ancestry_attn", "psi_gather_dot": "psi_gather_dot",
    "kv_reorder_bhtd": "kv_reorder", "kv_reorder_tbhd": "kv_reorder"}
# kernel name -> number of launches; each wrapper adds one where it launches
# its kernel, and nowhere else
launch_counts: Dict[str, int] = {name: 0 for name in KERNEL_SOURCES}
# name -> {"seconds": build time (0.0 when reused), "log": nvcc output}
build_info: Dict[str, dict] = {}


def route(x, op: str) -> str:
    """Which implementation runs for a tensor on ``x.device``: the plain
    PyTorch version only for the CPU, the kernel for CUDA, nothing else."""
    kind = x.device.type
    if kind == "cpu":
        return "plain"
    if kind == "cuda":
        return "kernel"
    raise RuntimeError(f"{op}: no implementation for device {kind}")


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from source at first use")
    return found


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` into a shared library unless a build of the
    same source (and the same ``csrc/*.cuh`` headers) already exists; return
    the library's path."""
    src = CSRC / f"{name}.cu"
    # the shared headers count too: an edited header rebuilds every source
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = BUILD_ROOT / f"{name}-{digest}"
    lib = out_dir / f"lib{name}.so"
    if lib.exists():
        # keep the record of a build made earlier in this process
        build_info.setdefault(name, {"seconds": 0.0, "log": ""})
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".lib{name}.{os.getpid()}.so"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}\n"
                           f"{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    build_info[name] = {"seconds": time.perf_counter() - t0,
                        "log": proc.stdout + proc.stderr}
    return lib


def build_all(names) -> None:
    """Build several sources at once: one ``nvcc`` per source, all started
    together (each build is single-threaded and seconds long)."""
    from concurrent.futures import ThreadPoolExecutor

    names = list(names)
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        list(pool.map(build, names))


# source -> {C entry point: (pointers, ints)}; each entry point takes that
# many pointers, then that many ints, then the stream, and returns the
# launch's cudaError_t. Typed once, when the library loads.
ENTRY_POINTS: Dict[str, Dict[str, tuple]] = {
    "flash_attn_fwd": {"flash_attn_fwd": (5, 5)},
    "flash_attn_bwd": {"flash_attn_bwd": (11, 5)},
    "ancestry_attn": {"ancestry_attn": (7, 7)},
    "psi_gather_dot": {"psi_gather_dot": (5, 8)},
    "kv_reorder": {"kv_reorder_bhtd": (3, 4), "kv_reorder_tbhd": (3, 4)}}


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` and type its entry
    points; cached per process."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for fn_name, (n_ptrs, n_ints) in ENTRY_POINTS[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = [ctypes.c_void_p] * n_ptrs \
                    + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def flash_attn_fwd_lib() -> ctypes.CDLL:
    return load("flash_attn_fwd")


def flash_attn_bwd_lib() -> ctypes.CDLL:
    return load("flash_attn_bwd")


def ancestry_attn_lib() -> ctypes.CDLL:
    return load("ancestry_attn")


def psi_gather_dot_lib() -> ctypes.CDLL:
    return load("psi_gather_dot")


def kv_reorder_lib() -> ctypes.CDLL:
    return load("kv_reorder")
