"""The memory probe of ``auto_find_batch_size`` (``Trainer.probe_step``
under parallel/mesh.py::local_collectives) over gloo on the CPU, on the
tiny model and corpus of tests/test_torch_autobatch_sharded.py:

- it runs no collective: rank 0 probes alone under FSDP2 on [2] and under
  tensor parallelism on [1, 2] while rank 1 waits at a barrier, and
  finishes within the spawn's timeout;
- it allocates what a training step allocates: FSDP2's comms during one
  probe make the same ``allocate`` calls (kind, size, dtype, in order) as
  the default comms during one real micro-batch;
- it leaves no trace: afterwards FSDP2 holds its default comms again, the
  tensor-parallel all-reduces are real again, and the next real step's
  loss and parameters equal those of a model that was never probed.

The FDDT preheat is off here, so that the real step trains the base
phase's parameters, which the probe's backward computes."""

import pytest
import torch

import torch_mp_worker as W
from test_torch_autobatch_sharded import (MESHES, sharded_corpus,  # noqa: F401
                                          train_overrides)

TIMEOUT = 180
BASE_PHASE = ("training.use_fddt_only_n_steps=0",)


@pytest.mark.parametrize("mesh", ["fsdp_2", "tp_1x2"])
def test_probe_on_one_rank_alone_completes(
        mesh, sharded_corpus, tmp_path):  # noqa: F811
    ranks = W.spawn("probe_alone", tmp_path, 2, {
        "overrides": train_overrides(sharded_corpus, tmp_path / "out",
                                     mesh)}, timeout=TIMEOUT)
    assert [r["probed_alone"] for r in ranks] == [True, False]
    # the gradients are dropped
    assert [r["grads_left"] for r in ranks] == [0, 0]


@pytest.mark.parametrize("mesh", ["fsdp_2", "tp_1x2"])
def test_probe_allocates_as_a_step_and_leaves_no_trace(
        mesh, sharded_corpus, tmp_path):  # noqa: F811
    ranks = W.spawn("probe_comms", tmp_path, 2, {
        "overrides": train_overrides(sharded_corpus, tmp_path / "out", mesh,
                                     *BASE_PHASE)}, timeout=TIMEOUT)
    for rank, r in enumerate(ranks):
        # (kind, size, dtype) of each call, and the class that made it
        calls = [[c[:3] for c in r[k]]
                 for k in ("probe_allocs", "probed_allocs", "plain_allocs")]
        assert calls[0] == calls[1] == calls[2]
        if mesh == "fsdp_2":
            assert {c[0] for c in r["probe_allocs"]} == {"all_gather",
                                                         "reduce_scatter"}
            assert {c[3] for c in r["probe_allocs"]} == {
                "_LocalAllGather", "_LocalReduceScatter"}
            assert {c[3] for c in r["probed_allocs"] + r["plain_allocs"]} \
                == {"DefaultAllGather", "DefaultReduceScatter"}
            assert r["comms_after_probe"] == ["DefaultAllGather",
                                              "DefaultReduceScatter"]
        else:
            assert r["probe_allocs"] == [] and r["comms_after_probe"] == []
        assert r["local_only_after_probe"] is False
        assert r["probed_parts"] == r["plain_parts"]
        probed = torch.load(tmp_path / f"state{rank}_probed.pt")
        plain = torch.load(tmp_path / f"state{rank}_plain.pt")
        assert set(probed) == set(plain)
        for k, v in plain.items():
            assert torch.equal(probed[k], v), k
