"""The port's ZeRO-style fine-tune (``training.shard_params``: FSDP2 over
the ``data`` mesh, 2 ranks over gloo on the CPU) against its DDP run on the
same weights and ragged global batches (tests/test_torch_ddp.py): the same
logged losses and gradient norms at rtol 1e-5, as the JAX package's ZeRO
test holds them, also under each remat policy (the checkpointed layers
recomputed in the backward, under ``'attn'`` through ``attn_in`` /
``attn_out``, registered as FSDP2 forward methods); and a checkpoint saved from
the sharded model, restored before the wrapper, that gives the
single-process run's state dict."""

import numpy as np
import pytest
import torch

import torch_mp_worker as W
from test_torch_ddp import (assert_losses_close, make_case, run_ranks,
                            run_single)


@pytest.fixture(scope="module")
def ddp_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ddp")
    case = make_case("dicow", tmp)
    ranks, states, _ = run_ranks(case, tmp)
    return ranks[0]["logged"], states[0]


def _assert_matches_ddp(ranks, ddp_logged):
    r0, r1 = ranks
    assert r0["logged"] == r1["logged"]
    assert r0["phase"] == "base" and r0["updates"] == 2
    assert_losses_close(r0["logged"], ddp_logged, 1e-5,
                        keys=("loss", "dec_loss", "ctc_loss", "grad_norm"))


def test_fsdp_matches_ddp_and_checkpoint_gives_one_process_state(
        ddp_run, tmp_path):
    ddp_logged, ddp_state = ddp_run
    case = make_case("dicow", tmp_path)
    case["args"]["ckpt"] = str(tmp_path / "ckpt")
    ranks, states, out = run_ranks(case, tmp_path,
                                   "training.shard_params=true")
    _assert_matches_ddp(ranks, ddp_logged)
    assert ranks[0]["ckpt_step"] == 3
    single, single_state = run_single(case, tmp_path)
    saved = torch.load(tmp_path / "ckpt" / "step_3" / "state.pt")["params"]
    restored = [torch.load(tmp_path / "ranks" / f"restored{r}.pt")
                for r in range(2)]
    assert set(saved) == set(single_state) == set(states[0])
    for k, v in saved.items():
        # the gathered whole tensors are every rank's alike, the checkpoint
        # holds them and restores them into a sharded model
        for state in (states[0], states[1], *restored):
            assert torch.equal(state[k], v), k
        np.testing.assert_allclose(v.numpy(), single_state[k].numpy(),
                                   atol=1e-6, err_msg=k)
        np.testing.assert_allclose(v.numpy(), ddp_state[k].numpy(),
                                   atol=1e-6, err_msg=k)
    # one checkpoint directory, written by rank 0
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == \
        ["latest", "step_3"]


@pytest.mark.parametrize("policy", ["full", "dots", "attn"])
def test_fsdp_under_remat_matches_ddp(ddp_run, tmp_path, policy):
    case = make_case("dicow", tmp_path)
    ranks, _, _ = run_ranks(case, tmp_path, "training.shard_params=true",
                            "training.gradient_checkpointing=true",
                            f"training.remat_policy={policy}")
    _assert_matches_ddp(ranks, ddp_run[0])
