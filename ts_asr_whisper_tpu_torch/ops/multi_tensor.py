"""Multi-tensor kernels of the fine-tune's optimizer step
(``kernels/csrc/adamw_multi.cu``): many leaves in one launch.

- ``sq_norm_multi``: the sums of squares of lists of tensors, a TP-sharded
  and a whole sum for each list, behind ``utils/observability.py::
  global_norm`` for CUDA tensors (its plain version, ``_sq_sum``, serves the
  CPU).
- ``AdamWTable``: the clip and AdamW update of every trained leaf of
  ``training/optim.py::AdamW`` for CUDA parameters (its plain version, the
  per-leaf loop there, serves the CPU and is the card tests' reference).

Neither kernel replaces a TPU kernel: on the TPU, XLA fused optax's update.
Each launch takes its leaves as one table passed by value (at most
``MAX_LEAVES`` a launch; longer lists take several), so an update copies
nothing to the card and never waits for it. The host computes every scalar
of the update as the plain loop does; the card decides the clip from the
norm in its memory.
"""

from __future__ import annotations

import itertools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import launch_counts, raw_stream

# what the kernels read: fp32 or bf16, flagged by these bits of a leaf's meta
GROUP1, P_BF16, M_BF16, G_BF16 = 1, 2, 4, 8
MAX_NUMEL = 2 ** 31 - 1


class Segment(NamedTuple):
    """Leaves [first, last) of one launch; ``chunk_end[i]`` is the running
    count, within the launch, of the chunk-sized blocks through leaf
    ``first + i``."""
    first: int
    last: int
    chunk_end: np.ndarray


def plan_segments(numels: Sequence[int], chunk: int,
                  max_leaves: int) -> List[Segment]:
    """The launches over leaves of ``numels`` elements: at most
    ``max_leaves`` leaves each; a leaf of n elements takes ceil(n / chunk)
    blocks, an empty one none."""
    out = []
    for first in range(0, len(numels), max_leaves):
        last = min(first + max_leaves, len(numels))
        blocks = -(-np.asarray(numels[first:last], dtype=np.int64) // chunk)
        out.append(Segment(first, last, np.cumsum(blocks)))
    return out


def slot_ends(slots: Sequence[int], segments: Sequence[Segment],
              n_slots: int) -> np.ndarray:
    """For leaves sorted by ``slots``, the running count of blocks over all
    launches through each slot: slot s sums the partials
    [ends[s - 1], ends[s])."""
    bases = np.cumsum([0] + [int(s.chunk_end[-1]) for s in segments[:-1]])
    leaf_end = [s.chunk_end + b for s, b in zip(segments, bases)]
    through = np.searchsorted(np.asarray(slots, dtype=np.int64),
                              np.arange(n_slots), side="right")
    return np.concatenate([[0], *leaf_end])[through].astype(np.int32)


def _lib():
    from ..kernels import adamw_multi_lib

    return adamw_multi_lib()


def limits() -> Tuple[int, int, int]:
    """The build's (elements a block takes, leaves a launch takes, slots
    ``sq_norm_multi`` sums)."""
    lib = _lib()
    return tuple(lib.adamw_multi_limit(i) for i in range(3))


def _check(t: torch.Tensor, device: torch.device, what: str) -> int:
    """The kernels' dtype code of ``t`` (1 for bf16); raises on what they do
    not take."""
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: {t.dtype} (the kernel takes float32 or "
                        "bfloat16)")
    if t.device != device or not t.is_contiguous() or t.numel() > MAX_NUMEL:
        raise ValueError(f"{what}: {tuple(t.shape)} on {t.device}, "
                         f"contiguous {t.is_contiguous()} (the kernel takes "
                         f"contiguous tensors on {device} of at most "
                         f"{MAX_NUMEL} elements)")
    return int(t.dtype is torch.bfloat16)


def sq_norm_multi(parts: Sequence[Sequence[Tuple[torch.Tensor, bool]]],
                  device: torch.device) -> torch.Tensor:
    """(2, len(parts)) fp32 on ``device``: row 0 the sum of squares of each
    part's TP-sharded tensors (the flag of each (tensor, sharded) pair),
    row 1 of the others; an empty sum is 0. One launch for every part (a
    launch per MAX_LEAVES tensors past that); at least one tensor. Each
    square is taken in fp32 and the sums in double, in an order fixed by
    the tensors' sizes: the same tensors give the same bits."""
    lib = _lib()
    chunk, max_leaves, max_slots = limits()
    n_parts = len(parts)
    n_slots = 2 * n_parts
    if not 0 < n_slots <= max_slots:
        raise ValueError(f"sq_norm_multi: {n_parts} parts (1 to "
                         f"{max_slots // 2})")
    leaves = sorted(((i if sharded else n_parts + i, t)
                     for i, part in enumerate(parts) for t, sharded in part),
                    key=lambda leaf: leaf[0])
    if not leaves:
        raise ValueError("sq_norm_multi: no tensors")
    slots = [s for s, _ in leaves]
    tensors = [t for _, t in leaves]
    bf16 = [_check(t, device, "sq_norm_multi") for t in tensors]
    numels = [t.numel() for t in tensors]
    segments = plan_segments(numels, chunk, max_leaves)
    ends = slot_ends(slots, segments, n_slots)
    scratch = torch.empty(max(int(ends[-1]), 1), dtype=torch.float64,
                          device=device)
    out = torch.empty((2, n_parts), dtype=torch.float32, device=device)
    stream = raw_stream(device)
    base = 0
    for k, seg in enumerate(segments):
        sl, n = slice(seg.first, seg.last), seg.last - seg.first
        ptrs = np.array([t.data_ptr() for t in tensors[sl]], dtype=np.uint64)
        ints = np.concatenate([np.asarray(numels[sl], dtype=np.int64),
                               seg.chunk_end, np.asarray(bf16[sl],
                                                         dtype=np.int64)]
                              ).astype(np.int32)
        err = lib.sq_norm_multi(
            ptrs.ctypes.data, ints.ctypes.data, ends.ctypes.data,
            scratch.data_ptr(), out.data_ptr(), n, base, n_slots,
            int(k == len(segments) - 1), device.index or 0, stream)
        if err != 0:
            raise RuntimeError(f"sq_norm_multi launch failed: CUDA error "
                               f"{err}")
        launch_counts["sq_norm_multi"] += 1
        base += int(seg.chunk_end[-1])
    return out


class AdamWTable:
    """The host table of ``adamw_multi``: each trained leaf's parameter (this
    rank's part of it), first and second moment, size, learning-rate group
    and dtypes, built with the optimizer and built again when any of those
    tensors has moved (a parameter reassigned in place of its data, say).
    An update writes only the gradients' pointers into it and launches.

    ``params``, ``mu`` and ``nu`` are the optimizer's own lists, read at
    every update; ``groups`` gives each leaf's learning-rate group (0 or
    1)."""

    def __init__(self, params: List[torch.Tensor], mu: List[torch.Tensor],
                 nu: List[torch.Tensor], groups: Sequence[int]):
        self.params, self.mu, self.nu = params, mu, nu
        self.groups = list(groups)
        self.device = params[0].device
        self.addresses: Optional[list] = None
        self.build()

    def _tensors(self):
        return itertools.chain(self.params, self.mu, self.nu)

    def build(self) -> None:
        chunk, max_leaves, _ = limits()
        dev = self.device
        meta = []
        for p, m, v, grp in zip(self.params, self.mu, self.nu, self.groups):
            p_bf16 = _check(p, dev, "adamw_multi parameter")
            m_bf16 = _check(m, dev, "adamw_multi first moment")
            _check(v, dev, "adamw_multi second moment")
            if v.dtype is not torch.float32 or not (
                    p.numel() == m.numel() == v.numel()):
                raise ValueError("adamw_multi: the moments must match their "
                                 "parameter in size, the second in float32")
            meta.append(grp * GROUP1 + p_bf16 * P_BF16 + m_bf16 * M_BF16)
        self.numels = [p.numel() for p in self.params]
        self.meta = np.array(meta, dtype=np.int32)
        self.segments = []
        for seg in plan_segments(self.numels, chunk, max_leaves):
            sl = slice(seg.first, seg.last)
            ptrs = np.array([0] * (seg.last - seg.first) + [
                t.data_ptr() for t in itertools.chain(
                    self.params[sl], self.mu[sl], self.nu[sl])],
                dtype=np.uint64)
            ints = np.concatenate([np.asarray(self.numels[sl], np.int64),
                                   seg.chunk_end, self.meta[sl]]
                                  ).astype(np.int32)
            self.segments.append((seg, ptrs, ints))
        self.addresses = [t.data_ptr() for t in self._tensors()]

    def step(self, grads: Sequence[Optional[torch.Tensor]],
             g_norm: torch.Tensor, hyper: np.ndarray) -> None:
        """One update of every leaf in place on the current stream.
        ``grads``: one per leaf, None read as zeros; ``g_norm``: their
        global norm (read on the card); ``hyper``: the fp32 scalars of the
        kernel's ``Hyper``, in order."""
        if [t.data_ptr() for t in self._tensors()] != self.addresses:
            self.build()
        dev = self.device
        if len(grads) != len(self.numels):
            raise ValueError(f"adamw_multi: {len(grads)} gradients for "
                             f"{len(self.numels)} leaves")
        gptr, gbits = [], []
        for g, n in zip(grads, self.numels):
            if g is None:
                gptr.append(0)
                gbits.append(0)
                continue
            gbits.append(G_BF16 * _check(g, dev, "adamw_multi gradient"))
            if g.numel() != n:
                raise ValueError(f"adamw_multi: a gradient of {g.numel()} "
                                 f"elements for a leaf of {n}")
            gptr.append(g.data_ptr())
        g_norm = g_norm.to(device=dev, dtype=torch.float32)
        hyper = np.ascontiguousarray(hyper, dtype=np.float32)
        lib = _lib()
        stream = raw_stream(dev)
        for seg, ptrs, ints in self.segments:
            n = seg.last - seg.first
            ptrs[:n] = gptr[seg.first:seg.last]
            ints[2 * n:] = self.meta[seg.first:seg.last] | np.asarray(
                gbits[seg.first:seg.last], dtype=np.int32)
            err = lib.adamw_multi(ptrs.ctypes.data, ints.ctypes.data,
                                  hyper.ctypes.data, g_norm.data_ptr(), n,
                                  dev.index or 0, stream)
            if err != 0:
                raise RuntimeError(f"adamw_multi launch failed: CUDA error "
                                   f"{err}")
            launch_counts["adamw_multi"] += 1
