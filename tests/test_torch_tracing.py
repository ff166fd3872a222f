"""The port's spans and counters (utils/observability.py): nothing recorded
without a profiler, the profiler's clock, nesting per thread, and the spans
of the greedy loop, the seek loop, the fine-tune step and the loaders, with
outputs bit-identical traced and untraced."""

import json
import sys
import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import torch_parity_utils as U
from ts_asr_whisper_tpu_torch.config import load_config
from ts_asr_whisper_tpu_torch.decoding.generation_config import \
    GenerationConfig
from ts_asr_whisper_tpu_torch.decoding.greedy import greedy_decode
from ts_asr_whisper_tpu_torch.decoding.longform import longform_generate
from ts_asr_whisper_tpu_torch.training import trainer as TT
from ts_asr_whisper_tpu_torch.training.dataloader import (DataLoader,
                                                          eval_batches)
from ts_asr_whisper_tpu_torch.utils import observability as obs


def traced(fn, on=True):
    """(fn's result, its spans, its counts), under a CPU profiler trace
    when ``on``."""
    t0 = time.time_ns()
    if on:
        with profile(activities=[ProfilerActivity.CPU]):
            out = fn()
    else:
        out = fn()
    t1 = time.time_ns()
    return out, obs.spans_between(t0, t1), obs.counts_between(t0, t1)


def names(spans):
    return Counter(s.name for s in spans)


def _gen_cfg(cfg, **kw):
    return GenerationConfig(**{
        "max_length": 16, "decoder_start_token_id": cfg.decoder_start_token_id,
        "eos_token_id": cfg.eos_token_id, "pad_token_id": cfg.pad_token_id,
        "bos_token_id": cfg.bos_token_id,
        "no_timestamps_token_id": cfg.no_timestamps_token_id,
        "return_timestamps": True, **kw})


def test_nothing_recorded_without_a_profiler():
    assert not torch.autograd.profiler._is_profiler_enabled
    first = obs.span("a")
    assert obs.span("b") is first

    def work():
        with obs.span("a"):
            obs.count("c", 3)

    _, spans, counts = traced(work, on=False)
    assert spans == [] and counts == {}


def test_span_holds_its_profiler_event_on_the_shared_clock():
    def work():
        with obs.span("t.outer"):
            with obs.span("t.inner"):
                torch.ones(64).sum()
            obs.count("t.n", 2)

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.time_ns()
        work()
        t1 = time.time_ns()
    spans = {s.name: s for s in obs.spans_between(t0, t1)}
    assert obs.counts_between(t0, t1) == {"t.n": 2}
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() in spans]
    assert sorted(e.name() for e in events) == ["t.inner", "t.outer"]
    for e in events:
        s = spans[e.name()]
        assert s.start_ns <= e.start_ns()
        assert e.start_ns() + e.duration_ns() <= s.end_ns
    # a window clips the spans it cuts
    mid = (spans["t.outer"].start_ns + spans["t.outer"].end_ns) // 2
    clipped = {s.name: s for s in obs.spans_between(mid, t1)}
    assert clipped["t.outer"].start_ns == mid


def test_parents_nest_within_a_thread_only():
    def worker():
        with obs.span("w.outer"):
            with obs.span("w.inner"):
                pass

    def work():
        with obs.span("m.outer"):
            with obs.span("m.inner"):
                t = threading.Thread(target=worker)
                t.start()
                t.join()

    _, spans, _ = traced(work)
    seen = {s.name: s for s in spans}
    assert seen["m.outer"].parent == -1
    assert seen["m.inner"].parent == seen["m.outer"].index
    # the worker's span opened inside m.inner, but in another thread
    assert seen["w.outer"].parent == -1
    assert seen["w.inner"].parent == seen["w.outer"].index
    assert seen["w.outer"].thread != seen["m.outer"].thread
    assert seen["m.outer"].start_ns <= seen["w.outer"].start_ns \
        <= seen["w.outer"].end_ns <= seen["m.outer"].end_ns


def test_threads_lose_no_record():
    """Many threads opening nested spans and counting at once, switching
    as often as the interpreter allows: every span and increment kept,
    every span's parent its own thread's."""
    n_threads, n_spans = 12, 150

    def worker():
        for _ in range(n_spans):
            with obs.span("s.outer"):
                with obs.span("s.inner"):
                    obs.count("s.n")

    def work():
        threads = [threading.Thread(target=worker) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _, spans, counts = traced(work)
    finally:
        sys.setswitchinterval(old)
    assert names(spans) == {"s.outer": n_threads * n_spans,
                            "s.inner": n_threads * n_spans}
    assert counts == {"s.n": n_threads * n_spans}
    by_index = {s.index: s for s in spans}
    assert len(by_index) == len(spans)
    for s in spans:
        if s.name == "s.inner":
            outer = by_index[s.parent]
            assert outer.name == "s.outer" and outer.thread == s.thread
            assert outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns


@pytest.mark.parametrize("force_full_length", [False, True])
def test_greedy_spans_one_stop_check_a_step(force_full_length):
    _, _, tcfg, model = U.make_pair(seed=1)
    gen_cfg = _gen_cfg(tcfg, max_length=24)
    enc = torch.from_numpy((np.random.default_rng(0).standard_normal(
        (3, 300, 128)) * 2.0).astype(np.float32))
    prompt = torch.tensor([[tcfg.decoder_start_token_id, 1000, 1001]] * 3)
    max_new = 20
    dec = model.decoder
    calls = []
    step = dec.decoder_cached

    def counted(*a, **k):
        calls.append(1)
        return step(*a, **k)

    dec.decoder_cached = counted
    try:
        run = (lambda: greedy_decode(model, gen_cfg, enc, prompt, max_new,
                                     force_full_length=force_full_length))
        ref, off_spans, _ = traced(run, on=False)
        calls.clear()
        out, spans, counts = traced(run)
    finally:
        del dec.decoder_cached
    steps = len(calls) - 1  # the prompt's prefill is one call
    assert off_spans == []
    assert counts["greedy.steps"] == steps == names(spans)["greedy.step"]
    checks = names(spans)["greedy.stop_check"]
    if force_full_length:
        assert steps == max_new and checks == 0
    else:
        # one a step, and the one that ends the loop before max_new
        assert checks == steps + (steps < max_new)
    for a, b in zip(out, ref):
        if a is not None:
            assert torch.equal(a, b)


def test_greedy_stops_at_most_one_step_after_the_last_eos():
    """Rows that finish at different steps: the host reads the stop flag
    one step late, so the loop ends within one step of the step at which
    the last row emitted EOS, with one ``greedy.stop_check`` a step and the
    one that ends it; the outputs equal the untraced run's. Token 1270 is
    one these weights emit within a few steps, so it serves as EOS."""
    _, _, tcfg, model = U.make_pair(seed=1)
    gen_cfg = _gen_cfg(tcfg, max_length=24, return_timestamps=False,
                       eos_token_id=1270)
    rng = np.random.default_rng(0)
    rng.standard_normal((3, 300, 128))
    enc = torch.from_numpy((rng.standard_normal((3, 300, 128))
                            * 2.0).astype(np.float32))
    prompt = torch.tensor([[tcfg.decoder_start_token_id, 1000, 1001]] * 3)
    run = lambda: greedy_decode(model, gen_cfg, enc, prompt, 20)  # noqa: E731
    ref, _, _ = traced(run, on=False)
    out, spans, counts = traced(run)
    lengths = out.lengths.tolist()
    assert len(set(lengths)) > 1
    last_eos_step = max(lengths) - 1 - prompt.shape[1]
    steps = counts["greedy.steps"]
    assert last_eos_step + 1 <= steps <= last_eos_step + 2 < 20
    assert names(spans)["greedy.step"] == steps
    assert names(spans)["greedy.stop_check"] == steps + 1
    for a, b in zip(out, ref):
        if a is not None:
            assert torch.equal(a, b)


def test_seek_loop_spans_and_row_counters():
    _, _, tcfg, model = U.make_pair(seed=4)
    gen_cfg = _gen_cfg(tcfg, lang_ids=(1000, 1001, 1002))
    rng = np.random.default_rng(0)
    t_total, valid = 1800, (1700, 1000, 350)
    feats = rng.standard_normal((3, 80, t_total)).astype(np.float32)
    att = np.zeros((3, t_total), np.int64)
    stno = np.zeros((3, 4, t_total // 2), np.float32)
    for i, n in enumerate(valid):
        att[i, :n] = 1
        feats[i, :, n:] = 0.0
        lab = rng.integers(0, 4, size=t_total // 2)
        stno[i, lab, np.arange(t_total // 2)] = 1.0
        stno[i, :, n // 2:] = 0.0
        stno[i, 0, n // 2:] = 1.0
    forced = np.tile([[tcfg.decoder_start_token_id, 1000, 1003]], (3, 1))
    out, spans, counts = traced(lambda: longform_generate(
        model, gen_cfg, feats, stno, att, forced))
    n = names(spans)
    iters = n["seek.slice"]
    assert iters >= 2 and n["decode.longform"] == 1
    assert counts["seek.active_rows"] == out.windows_decoded
    assert counts["seek.bucket_rows"] >= counts["seek.active_rows"]
    for name in ("seek.encoder", "seek.decode", "seek.fetch",
                 "seek.segments"):
        assert n[name] == iters, name
    top = next(s for s in spans if s.name == "decode.longform")
    assert all(s.parent == top.index for s in spans
               if s.name.startswith("seek."))
    assert n["greedy.step"] > 0


def _trainer(tmp_path, *extra):
    _, _, tcfg, model = U.make_pair(seed=0, remove_timestamps_from_ctc=True)
    cfg = load_config([
        "model.dtype=float32", "training.use_fddt_only_n_steps=0",
        "training.use_fddt_only_n_epochs=0", "training.warmup_steps=0",
        "training.eval_strategy=no", "training.save_strategy=no",
        "training.logging_steps=1", "training.mesh_shape=[1]",
        f"training.output_dir={tmp_path}", *extra], n_devices=1)
    rng = np.random.default_rng(1)
    feats, stno = U.encoder_inputs(rng, b=2)
    labels = rng.integers(0, tcfg.timestamp_begin + 300, (2, 24))
    labels[:, :3] = [1994, 1995, 1996]
    batch = {"input_features": feats, "stno_mask": stno, "labels": labels,
             "upp_labels": labels.copy()}
    return TT.Trainer(cfg, model, num_prefix_tokens=2), batch


def test_train_step_spans_in_order_inside_the_step(tmp_path):
    tt, batch = _trainer(tmp_path)
    _, spans, _ = traced(lambda: tt.train_step(TT.to_device(batch, "cpu")))
    step = [s for s in spans if s.name == "train.step"]
    parts = sorted((s for s in spans if s.name.startswith("train.")
                    and s.name != "train.step"), key=lambda s: s.start_ns)
    assert len(step) == 1
    assert [s.name for s in parts] == ["train.forward", "train.backward",
                                       "train.grad_norm", "train.optimizer"]
    for a, b in zip(parts, parts[1:]):
        assert a.end_ns <= b.start_ns
    assert all(s.parent == step[0].index for s in parts)


def test_profile_dir_trace_holds_the_spans(tmp_path):
    """``training.profile_dir``: the Chrome trace that ``Trainer.train``
    writes holds the step's spans."""
    tt, batch = _trainer(tmp_path, f"training.profile_dir={tmp_path}/prof",
                         "training.max_steps=2")
    tt.train(iter([batch, batch]))
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    got = Counter(e.get("name") for e in trace["traceEvents"])
    for name in ("train.step", "train.forward", "train.backward",
                 "train.grad_norm", "train.optimizer"):
        assert got[name] == 2, name


@pytest.mark.parametrize("kind", ["thread_loader", "eval_batches"])
def test_loader_spans_one_a_batch(kind):
    data = list(range(10))

    def collate(items):
        return np.asarray(items)

    if kind == "thread_loader":
        run = (lambda: list(DataLoader(data, collate, 2, shuffle=False,
                                       num_workers=2, num_epochs=1)))
        span_name = "loader.batch"
    else:
        run = (lambda: list(eval_batches(data, collate, 3)))
        span_name = "data.eval_batch"
    batches, spans, _ = traced(run)
    n = names(spans)
    assert n[span_name] == len(batches)
    if kind == "thread_loader":
        # the consumer waits once a batch and once for the end
        assert n["loader.wait"] == len(batches) + 1
        main = threading.get_ident()
        assert all(s.thread != main for s in spans
                   if s.name == "loader.batch")
