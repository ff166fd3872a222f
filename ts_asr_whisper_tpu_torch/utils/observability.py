"""Observability of the port: metrics logging, device profiling, and the
program's own spans and counters.

``MetricsLogger`` is the JAX package's (ts_asr_whisper_tpu/utils/
observability.py:24-73) as it is: a JSONL metrics stream (``metrics.jsonl``)
plus an optional wandb passthrough. ``start_trace``/``stop_trace`` and
``grad_param_norms`` are the torch counterparts of the JAX helpers:
``torch.profiler`` in place of ``jax.profiler``, norms over tensors in place
of ``optax.global_norm`` over pytrees.

``span(name)`` and ``count(name, n)`` mark the program's stages. They record
only while a ``torch.profiler`` trace is recording, in any thread: a span
keeps ``(name, start_ns, end_ns, parent, thread, index)`` on
``time.time_ns()``, the clock the profiler stamps its events with, so each
gap in the trace's device activity falls in the span the host was in; it
also opens the profiler's annotation of ``name`` (``record_function``),
which puts it into the Chrome trace (``training.profile_dir``). With no
trace recording, ``span`` returns one shared object that does nothing and
reads no clock.
``spans_between`` and ``counts_between`` read what a window recorded.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
from collections import deque
from pathlib import Path
from typing import (Dict, Iterable, List, NamedTuple, Optional, Sequence,
                    Tuple)

import torch
import torch.autograd.profiler as _autograd_profiler

from ..kernels import route


class MetricsLogger:
    def __init__(self, output_dir: str, run_name: str = "run",
                 use_wandb: bool = False, project: str = "dicow"):
        self.path = Path(output_dir) / "metrics.jsonl"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._file = open(self.path, "a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb
                wandb.init(project=project, name=run_name, id=run_name,
                           resume="allow")
            except Exception:
                self._wandb = None

    def log(self, metrics: Dict[str, float], step: int) -> None:
        rec = {"step": step, "time": time.time(),
               **{k: float(v) for k, v in metrics.items()}}
        self._file.write(json.dumps(rec) + "\n")
        self._file.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def log_predictions(self, hyps, refs, step: int,
                        rows_to_log: int = 10, tag: str = "") -> Path:
        """Eval prediction table (reference write_wandb_pred,
        evaluation.py:37-51): first N (label, hypothesis) string pairs as
        a JSONL artifact next to the metrics stream, mirrored to a wandb
        Table when wandb is live. Returns the artifact path."""
        suffix = f"_{tag}" if tag else ""
        path = self.path.parent / f"eval_predictions{suffix}_step{step}.jsonl"
        rows = [[i, ref, hyp] for i, (hyp, ref) in
                enumerate(zip(hyps, refs)) if i < rows_to_log]
        with open(path, "w") as f:
            for i, ref, hyp in rows:
                f.write(json.dumps({"id": i, "label_str": ref,
                                    "hyp_str": hyp}) + "\n")
        if self._wandb is not None:
            self._wandb.log(
                {f"eval_predictions{suffix}/step_{step}": self._wandb.Table(
                    columns=["id", "label_str", "hyp_str"], data=rows)},
                step=step)
        return path

    def close(self):
        self._file.close()
        if self._wandb is not None:
            self._wandb.finish()


def start_trace(log_dir: str):
    """Start a torch.profiler trace of CPU and, where present, CUDA
    activity (the counterpart of jax.profiler.start_trace)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def stop_trace(prof, log_dir: str) -> Path:
    """Stop ``prof`` and write its Chrome trace under ``log_dir``."""
    prof.stop()
    path = Path(log_dir) / "trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    return path


# -- spans and counters on the profiler's clock -----------------------------

# records kept of each kind, the oldest dropped first: a long-form batch of
# 8 seek windows of 125 greedy steps makes ~2,100 spans, a training update
# ~20
MAX_RECORDS = 1 << 18


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int   # ``index`` of the enclosing span of the thread, or -1
    thread: int   # ``threading.get_ident()`` of the thread it ran in
    index: int    # the span's number, in the order spans open


# the profiler's annotation of a span: its C++ one where torch has it (~1 us
# a span on a CPU), else ``record_function``, which goes through the
# dispatcher (~11 us)
_Annotation = getattr(torch._C._profiler, "_RecordFunctionFast",
                      torch.profiler.record_function)
_spans: "deque[Span]" = deque(maxlen=MAX_RECORDS)
_counts: "deque[Tuple[str, int, int]]" = deque(maxlen=MAX_RECORDS)
_open = threading.local()
_index = itertools.count()
_NO_SPAN = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "start_ns", "parent", "index", "annotation")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.parent = stack[-1] if stack else -1
        self.index = next(_index)
        stack.append(self.index)
        self.start_ns = time.time_ns()
        self.annotation = _Annotation(self.name)
        self.annotation.__enter__()
        return self

    def __exit__(self, *exc):
        self.annotation.__exit__(*exc)
        end_ns = time.time_ns()
        _open.stack.pop()
        _spans.append(Span(self.name, self.start_ns, end_ns, self.parent,
                           threading.get_ident(), self.index))
        return False


# Both read the profiler's flag of the process: its C++ state
# (``torch._C._autograd._profiler_enabled()``) is per thread, and the
# loader's threads would never see it.
def span(name: str):
    """``with span(name): ...`` records the block as a span while a trace
    is recording; it never synchronises the device."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to counter ``name`` at this instant while a trace is
    recording."""
    if _autograd_profiler._is_profiler_enabled:
        _counts.append((name, time.time_ns(), int(n)))


def spans_between(start_ns: int, end_ns: int) -> List[Span]:
    """The spans that overlap ``[start_ns, end_ns]``, clipped to it, in the
    order they closed."""
    return [s._replace(start_ns=max(s.start_ns, start_ns),
                       end_ns=min(s.end_ns, end_ns))
            for s in tuple(_spans)
            if s.end_ns >= start_ns and s.start_ns <= end_ns]


def counts_between(start_ns: int, end_ns: int) -> Dict[str, int]:
    """Each counter's increments made in ``[start_ns, end_ns]``, summed."""
    out: Dict[str, int] = {}
    for name, t_ns, n in tuple(_counts):
        if start_ns <= t_ns <= end_ns:
            out[name] = out.get(name, 0) + n
    return out


def _sq_sum(tensors: Sequence[torch.Tensor]) -> Optional[torch.Tensor]:
    if not tensors:
        return None
    return torch.stack([t.float().square().sum() for t in tensors]).sum()


def _norms(parts: Sequence[Sequence[Tuple[torch.Tensor, bool]]],
           group=None, tp_group=None) -> torch.Tensor:
    """The fp32 norm of each part, a list of (tensor, TP-sharded) pairs: the
    squares of the TP-sharded tensors (this rank's slices) added over
    ``tp_group`` in one all-reduce, those of the others counted once, then
    every part's sum added over ``group`` (the FSDP2 shards) in one
    all-reduce. The sums of CUDA tensors are one launch of
    ``sq_norm_multi`` (``ops/multi_tensor.py``), of CPU tensors
    ``_sq_sum``'s."""
    first = next((t for part in parts for t, _ in part), None)
    if first is not None and route(first, "global_norm") == "kernel":
        from ..ops.multi_tensor import sq_norm_multi

        tp_tot, rep_tot = sq_norm_multi(parts, first.device)
    else:
        tp_sq = [_sq_sum([t for t, sharded in part if sharded])
                 for part in parts]
        rep_sq = [_sq_sum([t for t, sharded in part if not sharded])
                  for part in parts]
        dev = next((s.device for s in tp_sq + rep_sq if s is not None),
                   torch.device("cpu"))
        zero = torch.zeros((), device=dev)
        tp_tot = torch.stack([zero if s is None else s for s in tp_sq])
        rep_tot = torch.stack([zero if s is None else s for s in rep_sq])
    if tp_group is not None:
        torch.distributed.all_reduce(tp_tot, group=tp_group)
    total = tp_tot + rep_tot
    if group is not None:
        torch.distributed.all_reduce(total, group=group)
    return total.sqrt()


def global_norm(tensors: Iterable[Optional[torch.Tensor]], group=None,
                sharded: Optional[Sequence[bool]] = None,
                tp_group=None) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32
    (optax.global_norm); a None tensor counts as zeros. With ``group``, the
    tensors are this rank's shards of tensors sharded over the group's
    ranks (FSDP2); with ``tp_group``, those flagged in ``sharded`` are this
    rank's slices of tensors split over the ``model`` group (tensor
    parallelism), the others whole on every rank of it. One all-reduce per
    group; every rank gets the norm of the whole tensors."""
    tensors = list(tensors)
    flags = sharded if sharded is not None else [False] * len(tensors)
    pairs = [(t, f) for t, f in zip(tensors, flags) if t is not None]
    if not pairs:
        return torch.zeros(())
    return _norms([pairs], group, tp_group)[0]


def module_grad_norms(named: Iterable[Tuple[str, torch.nn.Parameter]],
                      sep: str = ".", group=None,
                      tp_group=None) -> Dict[str, torch.Tensor]:
    """Gradient norm per module: the first two parts of the parameter name
    (``model.`` dropped) joined by ``sep``, as ``grad_norm/<top><sep><mod>``.
    A parameter without a gradient counts as a zero gradient. ``group``:
    the parameters are sharded over its ranks; ``tp_group``: tensor-
    parallel ones are sliced over it (``global_norm``, one all-reduce per
    group for all modules)."""
    from ..parallel.mesh import local
    from ..parallel.tensor import tp_dim

    groups: Dict[str, list] = {}
    for name, p in named:
        key = sep.join(name.removeprefix("model.").split(".")[:2])
        grads = groups.setdefault(f"grad_norm/{key}", [])
        if p.grad is not None:
            grads.append((local(p.grad), tp_group is not None
                          and tp_dim(name) is not None))
    keys = list(groups)
    if not keys:
        return {}
    norms = _norms([groups[k] for k in keys], group, tp_group)
    return dict(zip(keys, norms))


def grad_param_norms(named: Iterable[Tuple[str, torch.nn.Parameter]]
                     ) -> Dict[str, float]:
    """GradLogger equivalent: global and per-module norms of gradients and
    the global norm of parameters."""
    named = list(named)
    out = {"grad_norm/global": float(global_norm(
        p.grad for _, p in named if p.grad is not None)),
        "param_norm/global": float(global_norm(p.detach() for _, p in named))}
    out.update({k: float(v) for k, v in module_grad_norms(named).items()})
    return out
