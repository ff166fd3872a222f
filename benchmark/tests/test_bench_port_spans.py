"""The readers of the port's own spans and counters
(``benchmark/portspans.py``) on a fake trace, with spans and counters put
into the port's recorder (``utils/observability.py``) in a window of their
own; and None without a trace, without spans, or on a port without the
recorder."""

from collections import deque

import pytest

from benchmark import harness
from benchmark.devicetime import union_s
from ts_asr_whisper_tpu_torch.utils import observability as obs

MS = 1_000_000  # ns
T0 = 10 ** 15   # a window of the fake clock that no real span reaches
MAIN, WORKER_A, WORKER_B = 1, 2, 3


@pytest.fixture(autouse=True)
def recorder(monkeypatch):
    """An empty recorder of the port's for each test."""
    monkeypatch.setattr(obs, "_spans", deque())
    monkeypatch.setattr(obs, "_counts", deque())


def put(spans, counts):
    """(name, start ms, end ms, thread) spans and (name, ms, n) counts into
    the port's recorder, at T0 + ms on its clock."""
    for k, (name, s, e, thread) in enumerate(spans):
        obs._spans.append(obs.Span(name, T0 + s * MS, T0 + e * MS, -1,
                                   thread, -1 - k))
    for name, t, n in counts:
        obs._counts.append((name, T0 + t * MS, n))


def trace(records, end_ms):
    records = sorted((n, T0 + s * MS, T0 + e * MS) for n, s, e in records)
    return {"records": records, "busy_s": union_s(records),
            "window_s": end_ms / 1e3, "start_ns": T0,
            "end_ns": T0 + end_ms * MS}


def decode_ctx():
    """Two batches of 16 rows (4 row-windows in the work), two seek
    iterations with one fallback retry, two greedy steps."""
    spans = [("data.eval_batch", 0, 40, MAIN), ("data.eval_batch", 100, 140,
                                                 MAIN)]
    spans += [("data.features", 2 + 10 * k, 10 + 10 * k, MAIN)
              for k in range(4)]
    spans += [("decode.longform", 40, 100, MAIN),
              ("seek.upload", 40, 42, MAIN),
              ("seek.slice", 42, 45, MAIN), ("seek.slice", 70, 73, MAIN),
              ("seek.encoder", 45, 46, MAIN), ("seek.encoder", 73, 74, MAIN),
              # the first iteration's decode and its fallback retry
              ("seek.decode", 46, 60, MAIN), ("seek.decode", 67, 69, MAIN),
              ("seek.decode", 74, 90, MAIN),
              ("seek.fetch", 60, 61, MAIN), ("seek.fetch", 64, 65, MAIN),
              ("seek.fetch", 90, 91, MAIN),
              ("seek.segments", 61, 64, MAIN), ("seek.segments", 65, 67,
                                                MAIN),
              ("seek.segments", 91, 96, MAIN),
              # the steps: 10 ms each, then a 1 ms stop check
              ("greedy.step", 46, 56, MAIN), ("greedy.stop_check", 56, 57,
                                              MAIN),
              ("greedy.step", 74, 84, MAIN), ("greedy.stop_check", 84, 85,
                                              MAIN)]
    counts = [("data.mel_calls", 5, 16), ("data.mel_calls", 105, 16),
              ("seek.bucket_rows", 44, 16), ("seek.active_rows", 44, 16),
              ("seek.bucket_rows", 72, 8), ("seek.active_rows", 72, 5),
              ("greedy.steps", 50, 1), ("greedy.steps", 80, 1)]
    # device busy 6 of the first step's 10 ms and all of its stop check; 3
    # of the second step's, and the record that runs on past its check
    records = [("gemv", 46, 50), ("gemv", 49, 52), ("cast", 56, 57),
               ("gemv", 80, 83), ("cast", 84.5, 88)]
    put(spans, counts)
    return {"trace": trace(records, 200), "work": {"row_windows": 4}}


def train_ctx():
    """Two updates, the loader's batches in two worker threads."""
    spans = []
    for u in range(2):
        t = 100 * u
        spans += [("train.step", t, t + 90, MAIN),
                  ("train.forward", t, t + 10, MAIN),
                  ("train.backward", t + 10, t + 40, MAIN),
                  ("train.grad_norm", t + 40, t + 44, MAIN),
                  ("train.optimizer", t + 50, t + 90, MAIN),
                  ("loader.batch", t + 5, t + 35, WORKER_A),
                  ("loader.batch", t + 20, t + 30, WORKER_B)]
    # inside the first optimizer span: 8 ms, 2 of them twice over, and a
    # record that starts 5 ms before the span; 1 ms in the second
    records = [("add", 45, 52), ("mul", 60, 66), ("mul", 64, 68),
               ("add", 189, 190), ("attn_bwd", 12, 30)]
    put(spans, [])
    return {"trace": trace(records, 200), "work": {"updates": 2}}


SPEC = harness.Spec(harness.HERE.parent)
DECODE = {
    # 22 ms in the steps' and checks' spans, 10.5 of them busy
    "greedy_idle_ms.decode": (22 - 10.5) / 2,
    "greedy_stop_wait_ms.decode": 1.0,
    "seek_prep_ms.decode": (2 + 3 + 3) / 2,
    "seek_fetch_ms.decode": 3 / 2,
    "seek_segments_ms.decode": (3 + 2 + 5) / 2,
    # 60 ms of seek loop less 2 of encoder and 32 of decode
    "seek_self_port_ms.decode": (60 - 2 - 32) / 2,
    "bucket_fill.decode": 100 * 21 / 24,
    "mel_calls_per_batch.decode": 16.0,
    "featurize_ms.decode": 32 / 4,
}
TRAIN = {
    "fwd_host_ms.train": 10.0,
    "bwd_host_ms.train": 30.0,
    "grad_norm_ms.train": 4.0,
    "optim_busy_ms.train": (2 + 8 + 1) / 2,
    "loader_busy_ms.train": (30 + 10) * 2 / 2,
}


@pytest.mark.parametrize("name", sorted(DECODE) + sorted(TRAIN))
def test_port_span_reader(name):
    entry = next(m for m in SPEC.data["per_layer"] if m["name"] == name)
    cell = ("dicow_v3.greedy_longform" if name in DECODE
            else "dicow_v3.train")
    assert entry["workloads"] == [cell]
    ctx = decode_ctx() if name in DECODE else train_ctx()
    expected = DECODE.get(name, TRAIN.get(name))
    assert SPEC.reader(name)(ctx) == pytest.approx(expected)


@pytest.mark.parametrize("name", sorted(DECODE) + sorted(TRAIN))
def test_port_span_reader_finds_nothing(name, monkeypatch):
    """None without a trace, in a window the port recorded nothing in, and
    on a port that has no recorder."""
    read = SPEC.reader(name)
    ctx = decode_ctx() if name in DECODE else train_ctx()
    assert read(dict(ctx, trace=None)) is None
    empty = dict(ctx["trace"], start_ns=T0 - 10 ** 12,
                 end_ns=T0 - 10 ** 12 + 200 * MS)
    assert read(dict(ctx, trace=empty)) is None
    monkeypatch.delattr(obs, "spans_between")
    assert read(ctx) is None
