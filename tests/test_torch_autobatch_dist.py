"""``training.auto_find_batch_size`` of the port over 2 ranks (DDP over gloo
on the CPU), through ``ModelTrainer.train`` on the tiny model and corpus of
tests/test_torch_end_to_end.py: every rank probes its memory before the
first update (train.py::ModelTrainer._probe) and the ranks take one
decision together:

- an out-of-memory error in rank 1's probe alone halves the micro-batch and
  doubles the accumulation on both ranks, which then end where a 2-rank run
  started at those settings ends, bit for bit;
- another error in rank 1's probe stops both ranks, and rank 0's error
  names rank 1;
- without an error nothing halves, and the run ends where the same run
  without the option ends: the probe leaves no trace.

Each run is bounded by the spawn timeout, so a rank left waiting in a
collective fails the test instead of stalling the suite. And the scope:
``check_scope`` accepts the option under DDP, under FSDP2, under a
``model`` axis and under both (the probe runs no collective there either:
tests/test_torch_autobatch_{sharded,probe}.py), and accepts LoRA under
FSDP2."""

import pytest
import torch

import torch_mp_worker as W
from test_torch_dist import _cfg
from test_torch_end_to_end import _train_overrides, train_corpus  # noqa: F401
from ts_asr_whisper_tpu_torch.decode import check_scope

WORLD = 2
TIMEOUT = 240


def _run(corpus, out, tag, *extra, fault=None):
    """One fine-tune over the 2 ranks: the base config's, 4 micro-batches
    (one preheat epoch, then base ones) of 2 rows a rank."""
    return {"tag": tag, "fault": fault, "overrides": [
        *_train_overrides(corpus, out / tag), "training.mesh_shape=[2]",
        "training.max_steps=4", *extra]}


def _states(out, tag):
    return [torch.load(out / f"{tag}{r}.pt") for r in range(WORLD)]


def _assert_equal_states(got, want):
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k, v in w.items():
            assert torch.equal(g[k], v), k
    for k, v in got[0].items():
        assert torch.equal(got[1][k], v), k


def test_oom_on_one_rank_halves_every_rank(
        train_corpus, tmp_path):  # noqa: F811
    runs = [_run(train_corpus, tmp_path, "auto",
                 "training.auto_find_batch_size=true",
                 fault={"rank": 1, "error": "oom"}),
            _run(train_corpus, tmp_path, "ref",
                 "training.per_device_train_batch_size=1",
                 "training.gradient_accumulation_steps=2")]
    ranks = W.spawn("autobatch", tmp_path, WORLD, {"runs": runs},
                    timeout=TIMEOUT)
    for r in ranks:
        # rank 1's first probe failed; both probed again at micro-batch 1
        assert r["auto"] == {"probed": [2, 1], "batch": 1, "accum": 2}
        assert r["ref"] == {"probed": [], "batch": 1, "accum": 2}
    _assert_equal_states(_states(tmp_path, "auto"), _states(tmp_path, "ref"))


def test_other_error_on_one_rank_stops_every_rank(
        train_corpus, tmp_path):  # noqa: F811
    runs = [_run(train_corpus, tmp_path, "auto",
                 "training.auto_find_batch_size=true",
                 fault={"rank": 1, "error": "value"})]
    (rc0, out0), (rc1, out1) = W.spawn("autobatch", tmp_path, WORLD,
                                       {"runs": runs}, timeout=TIMEOUT,
                                       check=False)
    assert rc0 != 0 and rc1 != 0
    assert "ValueError: bad batch" in out1
    assert "RuntimeError: auto_find_batch_size: the memory probe failed " \
        "on rank(s) [1]" in out0
    assert "ValueError" not in out0


def test_no_error_no_halving_and_no_trace(
        train_corpus, tmp_path):  # noqa: F811
    runs = [_run(train_corpus, tmp_path, "auto",
                 "training.auto_find_batch_size=true"),
            _run(train_corpus, tmp_path, "ref")]
    ranks = W.spawn("autobatch", tmp_path, WORLD, {"runs": runs},
                    timeout=TIMEOUT)
    for r in ranks:
        assert r["auto"] == {"probed": [2], "batch": 2, "accum": 1}
        assert r["ref"]["probed"] == []
    _assert_equal_states(_states(tmp_path, "auto"), _states(tmp_path, "ref"))


@pytest.mark.parametrize("overrides", [
    ("training.auto_find_batch_size=true",),
    ("training.auto_find_batch_size=true", "training.mesh_shape=[2,1]",
     "training.mesh_axis_names=[data,model]"),
    ("training.auto_find_batch_size=true", "training.shard_params=true"),
    ("training.auto_find_batch_size=true", "training.mesh_shape=[1,2]",
     "training.mesh_axis_names=[data,model]"),
    ("training.auto_find_batch_size=true", "training.mesh_shape=[2,2]",
     "training.mesh_axis_names=[data,model]", "training.shard_params=true"),
    ("training.use_lora=true", "training.shard_params=true"),
    ("training.use_lora=true", "training.shard_params=true",
     "training.mesh_shape=[1,2]", "training.mesh_axis_names=[data,model]")])
def test_scope_accepts_auto_batch_under_ddp_and_lora_under_fsdp(overrides):
    # the mesh covers the world
    world = 4 if "training.mesh_shape=[2,2]" in overrides else 2
    check_scope(_cfg(*overrides), world=world)
