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
_libs: Dict[tuple, ctypes.CDLL] = {}
# the ``dtype`` argument of every C entry point
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# kernel name -> the csrc/<source>.cu that holds it
KERNEL_SOURCES: Dict[str, str] = {
    "flash_attn_fwd": "flash_attn_fwd", "flash_attn_bwd": "flash_attn_bwd",
    "ancestry_attn": "ancestry_attn", "psi_gather_dot": "psi_gather_dot",
    "kv_reorder_bhtd": "kv_reorder", "kv_reorder_tbhd": "kv_reorder",
    "adamw_multi": "adamw_multi", "sq_norm_multi": "adamw_multi"}
# kernel name -> number of launches; each wrapper adds one where it launches
# its kernel, and nowhere else
launch_counts: Dict[str, int] = {name: 0 for name in KERNEL_SOURCES}
# name (then its defines, if any) -> {"seconds": build time (0.0 when
# reused), "log": nvcc output}
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


def raw_stream(device: torch.device) -> int:
    """The handle of PyTorch's current CUDA stream on ``device`` (what
    ``torch.cuda.current_stream(device).cuda_stream`` gives, without making
    a Stream object on every launch)."""
    return torch._C._cuda_getCurrentRawStream(device.index or 0)


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


def build(name: str, defines: tuple = ()) -> Path:
    """Compile ``csrc/<name>.cu`` into a shared library unless a build of the
    same source (and the same ``csrc/*.cuh`` headers and ``defines``, extra
    ``-D`` flags that only probes pass) already exists; return the library's
    path."""
    src = CSRC / f"{name}.cu"
    flags = (*NVCC_FLAGS, *defines)
    # the shared headers count too: an edited header rebuilds every source
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(flags).encode()).hexdigest()[:16]
    out_dir = BUILD_ROOT / f"{name}-{digest}"
    lib = out_dir / f"lib{name}.so"
    key = " ".join((name, *defines))
    if lib.exists():
        # keep the record of a build made earlier in this process
        build_info.setdefault(key, {"seconds": 0.0, "log": ""})
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".lib{name}.{os.getpid()}.so"
    cmd = [find_nvcc(), *flags, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}\n"
                           f"{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    build_info[key] = {"seconds": time.perf_counter() - t0,
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
    "ancestry_attn": {"ancestry_attn": (8, 6)},
    "psi_gather_dot": {"psi_gather_dot": (5, 8)},
    "kv_reorder": {"kv_reorder_bhtd": (3, 4), "kv_reorder_tbhd": (3, 4)},
    "adamw_multi": {"adamw_multi": (4, 2), "sq_norm_multi": (5, 5)}}
# source -> C functions that take one int and return one: a build's limits
QUERIES: Dict[str, tuple] = {"ancestry_attn": ("ancestry_attn_max_len",),
                             "adamw_multi": ("adamw_multi_limit",)}


def load(name: str, defines: tuple = ()) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` and type its entry
    points; cached per process and ``defines``."""
    with _lock:
        lib = _libs.get((name, defines))
        if lib is None:
            lib = ctypes.CDLL(str(build(name, defines)))
            for fn_name, (n_ptrs, n_ints) in ENTRY_POINTS[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = [ctypes.c_void_p] * n_ptrs \
                    + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
            for fn_name in QUERIES.get(name, ()):
                fn = getattr(lib, fn_name)
                fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
            _libs[(name, defines)] = lib
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


def adamw_multi_lib() -> ctypes.CDLL:
    return load("adamw_multi")
