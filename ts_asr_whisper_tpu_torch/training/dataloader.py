"""Host data loading: shuffling sampler + threaded prefetch.

Replaces torch DataLoader workers (the reference's dataloader_num_workers /
prefetch_factor knobs, configs/base.yaml:58-60). Feature extraction and
collation run in a thread pool while the device executes the previous step —
the standard TPU host-overlap pattern.

Traced (utils/observability.py): each worker's batch is a ``loader.batch``
span, the consumer's wait for one a ``loader.wait`` span, and each batch of
``eval_batches`` a ``data.eval_batch`` span.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, List, Optional

import numpy as np

from ..utils.observability import span


class DataLoader:
    def __init__(self, dataset, collate_fn: Callable, batch_size: int,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True,
                 num_workers: int = 2, prefetch_factor: int = 2,
                 num_epochs: Optional[int] = None,
                 process_index: int = 0, process_count: int = 1,
                 worker_type: str = "thread"):
        """``batch_size`` is the GLOBAL batch. With ``process_count > 1``
        (multi-host SPMD) every process draws the same deterministic epoch
        permutation and yields only its contiguous slice of each global
        batch — rows [rank*local : (rank+1)*local] — matching what
        parallel/mesh.py::shard_batch assembles into the global array.
        The union of all processes' slices is exactly the single-process
        batch stream (the reference's DistributedSampler contract).

        ``worker_type``: "thread" (default) overlaps featurization with
        the device step — enough when per-core featurization outruns the
        chips. "process" forks ``num_workers`` OS workers (the torch
        dataloader_num_workers equivalent) for multi-core scaling past
        the GIL: a v5e-8 slice consumes ~54 samples/s at the measured
        step rate while one core featurizes ~40-50 samples/s, so feeding
        a pod slice needs real cores. Batches return pickled over pipes —
        at ~1 MB/sample mel payload and pod-slice demand that is ~55 MB/s
        against multi-GB/s pipe bandwidth, so a shared-memory handoff
        would save <2% and is not worth its lifecycle complexity. Workers
        are forked lazily at first iteration and inherit the dataset
        read-only (zero-copy); order and determinism match the thread
        path exactly."""
        self.dataset = dataset
        self.collate_fn = collate_fn
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch_factor)
        self.num_epochs = num_epochs
        if batch_size % max(process_count, 1):
            raise ValueError(
                f"global batch_size {batch_size} must divide evenly over "
                f"{process_count} processes")
        if process_count > 1 and not drop_last:
            raise ValueError("multi-process loading requires drop_last "
                             "(a ragged tail batch would desynchronize SPMD)")
        self.process_index = process_index
        self.process_count = max(process_count, 1)
        if worker_type not in ("thread", "process"):
            raise ValueError(f"worker_type must be 'thread' or 'process', "
                             f"got {worker_type!r}")
        self.worker_type = worker_type

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + epoch)
            rng.shuffle(idx)
        return idx

    def _batches(self) -> Iterator[List[int]]:
        if self.drop_last and len(self.dataset) < self.batch_size:
            raise ValueError(
                f"dataset has {len(self.dataset)} samples < batch_size "
                f"{self.batch_size} with drop_last — zero batches per epoch")
        epoch = 0
        while self.num_epochs is None or epoch < self.num_epochs:
            idx = self._epoch_indices(epoch)
            end = len(idx) - (len(idx) % self.batch_size
                              if self.drop_last else 0)
            local = self.batch_size // self.process_count
            lo = self.process_index * local
            for i in range(0, end, self.batch_size):
                yield idx[i + lo : i + lo + local].tolist()
            epoch += 1

    def __iter__(self):
        if self.worker_type == "process":
            yield from self._iter_processes()
            return
        yield from self._iter_threads()

    def _iter_threads(self):
        from concurrent.futures import ThreadPoolExecutor

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def make_batch(batch_idx):
            with span("loader.batch"):
                samples = [self.dataset[i] for i in batch_idx]
                return self.collate_fn(samples)

        def producer():
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    pending = []
                    for batch_idx in self._batches():
                        if stop.is_set():
                            return
                        pending.append(pool.submit(make_batch, batch_idx))
                        while len(pending) >= self.prefetch:
                            q.put(pending.pop(0).result())
                    for fut in pending:
                        if stop.is_set():
                            return
                        q.put(fut.result())
            except BaseException as e:  # surface worker errors to the consumer
                q.put(e)
                return
            finally:
                if not stop.is_set():
                    q.put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                with span("loader.wait"):
                    item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            # unblock a producer waiting on a full queue so it can observe
            # the stop flag and exit
            try:
                while not q.empty():
                    q.get_nowait()
            except Exception:
                pass

    def _iter_processes(self):
        """Forked OS workers pulling (seq, indices) tasks; the consumer
        reorders results so the batch stream is identical to the thread
        path. Errors pickle back and re-raise at the consumer; shutdown
        terminates workers so no zombie survives a broken iteration."""
        import multiprocessing as mp

        if "fork" not in mp.get_all_start_methods():
            yield from self._iter_threads()  # non-POSIX fallback
            return
        ctx = mp.get_context("fork")
        task_q = ctx.SimpleQueue()
        res_q = ctx.SimpleQueue()

        def worker():
            while True:
                item = task_q.get()
                if item is None:
                    return
                seq, idxs = item
                try:
                    batch = self.collate_fn([self.dataset[i] for i in idxs])
                    res_q.put((seq, batch, None))
                except BaseException as e:
                    try:
                        res_q.put((seq, None, e))
                    except Exception:  # unpicklable exception
                        res_q.put((seq, None, RuntimeError(repr(e))))

        workers = [ctx.Process(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for w in workers:
            w.start()

        # the feeder keeps at most prefetch*num_workers tasks in flight
        # (bounded host memory) and runs in a thread so infinite-epoch
        # streams never block construction
        inflight = threading.Semaphore(self.prefetch * self.num_workers)
        stop = threading.Event()
        total = [None]

        def feeder():
            n = 0
            for batch_idx in self._batches():
                while not inflight.acquire(timeout=0.2):
                    if stop.is_set():
                        return
                if stop.is_set():
                    return
                task_q.put((n, batch_idx))
                n += 1
            total[0] = n

        feed_thread = threading.Thread(target=feeder, daemon=True)
        feed_thread.start()
        try:
            expected = 0
            stash = {}
            while True:
                if total[0] is not None and expected >= total[0]:
                    break
                seq, batch, err = res_q.get()
                stash[seq] = (batch, err)
                while expected in stash:
                    batch, err = stash.pop(expected)
                    expected += 1
                    inflight.release()
                    if err is not None:
                        raise err
                    yield batch
        finally:
            stop.set()
            for _ in workers:
                try:
                    task_q.put(None)
                except Exception:
                    pass
            for w in workers:
                w.join(timeout=1.0)
                if w.is_alive():
                    w.terminate()
                    w.join(timeout=1.0)


def eval_batches(dataset, collate_fn: Callable, batch_size: int,
                 pad_to_full: bool = False,
                 batch_offset: int = 0, batch_stride: int = 1):
    """Sequential, non-shuffled batches covering the whole dataset.

    ``pad_to_full`` repeats the last sample so every batch has the same
    static shape (no recompilation for the tail batch); duplicates are
    deduplicated downstream by their (cut_id, spk_id) keys — the same
    mechanism the reference uses for DDP sampler repeats
    (evaluation.py:262-264).

    ``batch_offset``/``batch_stride`` shard batches round-robin across
    processes (the DDP eval sampler): only batches with index ≡ offset
    (mod stride) are collated, so skipped batches cost nothing. Yields
    (batch_index, batch) pairs so a multi-process gather can restore the
    global order."""
    n = len(dataset)
    for bi, i in enumerate(range(0, n, batch_size)):
        if bi % batch_stride != batch_offset:
            continue
        idx = list(range(i, min(i + batch_size, n)))
        if pad_to_full and len(idx) < batch_size and n > 0:
            idx = idx + [idx[-1]] * (batch_size - len(idx))
        with span("data.eval_batch"):
            samples = [dataset[j] for j in idx]
            batch = collate_fn(samples)
        yield bi, batch
