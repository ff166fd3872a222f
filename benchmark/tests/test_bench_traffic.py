"""The traffic generators: deterministic by seed, and the work they fix the
same for every seed."""

import numpy as np

from benchmark import harness
from benchmark.drivers import decode, train
from benchmark.traffic import synthetic

SPEC = harness.Spec(harness.HERE.parent)


def _flat(recs):
    return [(r.id, r.duration, tuple(r.speakers), tuple(r.turns))
            for r in recs]


def test_decode_plan_is_deterministic_by_seed():
    mix = SPEC.traffic("greedy_longform")
    a = synthetic.plan_batches(mix, 3, 2 ** 31 + 11, "b")
    b = synthetic.plan_batches(mix, 3, 2 ** 31 + 11, "b")
    c = synthetic.plan_batches(mix, 3, 2 ** 31 + 12, "b")
    assert _flat(a) == _flat(b)
    assert _flat(a) != _flat(c)


def test_decode_work_is_fixed_by_the_mix():
    """Row-windows and seek iterations of every batch are the same for
    every seed: 84 row-windows in 8 iterations at 16 rows."""
    mix = SPEC.traffic("greedy_longform")
    for seed in (0, 7, 2 ** 33 + 5):
        recs = synthetic.plan_batches(mix, 4, seed, "b")
        assert decode.batch_work(recs, 16) == [(84, 8)] * 4
        warm = synthetic.plan_batches(mix, 1, seed, "w")
        assert decode.batch_work(warm, 16) == [(84, 8)]


def test_every_speaker_talks_and_overlap_is_in_range():
    mix = SPEC.traffic("greedy_longform")
    for rec in synthetic.plan_batches(mix, 2, 99, "b"):
        assert {t[0] for t in rec.turns} == set(rec.speakers)
        assert all(0.3 <= s and s + d <= rec.duration for _, s, d, _ in
                   rec.turns)


def test_train_plan_is_deterministic_and_sized():
    mix = SPEC.traffic("train_30s")
    a, b = train.plan_cuts(mix, 5), train.plan_cuts(mix, 5)
    assert _flat(a) == _flat(b)
    assert _flat(a) != _flat(train.plan_cuts(mix, 6))
    assert len(a) == mix["cuts"]
    assert all(r.duration == 30.0 for r in a)
    counts = sorted(len(r.speakers) for r in a)
    assert counts == sorted(len(r.speakers) for r in train.plan_cuts(mix, 6))


def test_corpus_files_read_back(tmp_path):
    mix = SPEC.traffic("greedy_longform")
    recs = synthetic.plan_batches(mix, 1, 3, "b")[:1]
    synthetic.write_corpus(tmp_path, recs, 3, "x")
    wav = synthetic.read_wav(recs[0].path)
    assert wav.shape[0] == int(round(recs[0].duration * 16000))
    assert np.abs(wav).max() < 1.0


def test_a_window_at_the_corpus_end_is_a_work_mismatch(tmp_path):
    """The window corpus is never started again: a window that reaches its
    end counts as a mismatch, as does a batch off the plan."""
    import torch

    cell = decode.DecodeCell(SPEC, "dicow_v3.greedy_longform", 3,
                             torch.device("cpu"), tmp_path)
    cell.plan, cell.records = [(84, 8), (84, 8)], []
    whole = [(0, 84, 0.0), (1, 84, 0.0)]
    assert cell.expected_mismatch({"per_batch": whole,
                                   "exhausted": False}) == 0
    assert cell.expected_mismatch({"per_batch": whole,
                                   "exhausted": True}) == 1
    assert cell.expected_mismatch({"per_batch": [(0, 80, 0.0)],
                                   "exhausted": False}) == 1


def test_the_window_corpus_outlasts_three_times_todays_rate():
    """At least 18 batches: about three times the ~6 that a 51 s window
    decodes on one H100."""
    cell = SPEC.cell("dicow_v3.greedy_longform")
    assert cell["window_batches"] >= 18
