"""The port's LoRA fine-tune under FSDP2 (``training.shard_params``), on the
CPU over gloo, with the weights and ragged global batches of
tests/test_torch_ddp.py's LoRA case (one preheat update with the adapters
frozen, the unfreeze, two base updates):

- on a ``data`` mesh of 2 against DDP + LoRA on the same weights and
  batches: the same logged losses and gradient norms at rtol 1e-5 and the
  same gathered states at atol 1e-6 (tests/test_torch_fsdp.py's rule for
  dense runs);
- the same run against the JAX Trainer with ``shard_params=True`` on the
  same CPU mesh (its ``lora`` tree placed by ``param_shardings``): losses
  at rtol 1e-5, gradient norms at 1e-4;
- FSDP2 x TP on the mesh [2, 2] against the one-process LoRA run and the
  JAX Trainer on the same mesh, at the tolerances of
  tests/test_torch_tp_train.py.

On every case some ``lora_B`` moves (B starts at 0). And through the CLI on
2 ranks: LoRA under FSDP2 over bf16 weights is refused with its reason
(FSDP2 all-gathers one dtype per unit; the adapters stay fp32)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mp_worker as W
from test_torch_ddp import (LOSS_KEYS, assert_losses_close, overrides,
                            run_ranks)
from test_torch_tp_train import _case, _mesh_overrides, run_mesh, single_on
from test_torch_end_to_end import _train_overrides, train_corpus  # noqa: F401
from test_torch_train_step import NUM_PREFIX
from ts_asr_whisper_tpu.config import load_config
from ts_asr_whisper_tpu.parallel.mesh import make_mesh
from ts_asr_whisper_tpu.training import trainer as JT


@pytest.fixture(scope="module")
def fsdp_lora(tmp_path_factory):
    case = _case("lora", tmp_path_factory)
    ranks, states, _ = run_ranks(case, tmp_path_factory.mktemp("fsdp_lora"),
                                 "training.shard_params=true")
    r0, r1 = ranks
    assert r0["logged"] == r1["logged"]
    assert r0["phase"] == "base" and r0["updates"] == 2
    for k, v in states[0].items():
        assert torch.equal(v, states[1][k]), k
    return case, r0["logged"], states[0]


def _assert_lora_b_moved(state, case):
    start = torch.load(case["args"]["weights"])
    assert any(not torch.equal(state[k], start[k]) for k in start
               if k.endswith("lora_B"))


def jax_shard_params_losses(case, tmp_path, shape):
    """The JAX Trainer with ``shard_params=True`` over the global batches
    on a mesh of the suite's virtual CPU devices: [n] over ``data`` or
    [n, m] over ``data`` x ``model``."""
    out = tmp_path / "jax"
    mesh = ([f"training.mesh_shape=[{shape[0]}]"] if len(shape) == 1
            else _mesh_overrides(shape))
    jc = load_config(overrides(out, 1, case["accum"], *case["extra"])
                     + mesh + ["training.shard_params=true"], n_devices=1)
    params = jax.tree.map(jnp.asarray, case["params"])
    names = ("data",) if len(shape) == 1 else ("data", "model")
    JT.Trainer(jc, case["jcfg"], params, num_prefix_tokens=NUM_PREFIX,
               mesh=make_mesh(shape, names)).train(iter(case["batches"]))
    return [json.loads(line) for line in
            (out / "metrics.jsonl").read_text().splitlines()]


def test_lora_fsdp_matches_ddp(fsdp_lora, tmp_path):
    case, logged, state = fsdp_lora
    ranks, states, _ = run_ranks(case, tmp_path)
    assert_losses_close(logged, ranks[0]["logged"], 1e-5,
                        keys=(*LOSS_KEYS, "grad_norm"))
    assert set(state) == set(states[0])
    for k, v in state.items():
        np.testing.assert_allclose(v.numpy(), states[0][k].numpy(),
                                   atol=1e-6, err_msg=k)
    _assert_lora_b_moved(state, case)


def test_lora_fsdp_matches_jax_shard_params(fsdp_lora, tmp_path):
    case, logged, state = fsdp_lora
    ref = jax_shard_params_losses(case, tmp_path, (2,))
    assert_losses_close(logged, ref, 1e-5)
    assert_losses_close(logged, ref, 1e-4, keys=("grad_norm",))
    _assert_lora_b_moved(state, case)


def test_lora_fsdp_tp_matches_one_process_and_jax(tmp_path,
                                                  tmp_path_factory):
    case = _case("lora", tmp_path_factory)
    ranks, states = run_mesh(case, tmp_path, (2, 2),
                             "training.shard_params=true")
    single, single_state = single_on("lora", case, tmp_path_factory)
    ref = jax_shard_params_losses(case, tmp_path, (2, 2))
    for r in ranks:
        assert r["logged"] == ranks[0]["logged"]
        assert r["phase"] == "base" and r["updates"] == 2
    logged = ranks[0]["logged"]
    assert_losses_close(logged, single["logged"], 1e-5,
                        keys=(*LOSS_KEYS, "grad_norm"))
    assert_losses_close(logged, ref, 1e-5)
    assert_losses_close(logged, ref, 1e-4, keys=("grad_norm",))
    for k, v in states[0].items():
        for s in states[1:]:
            assert torch.equal(v, s[k]), k
        np.testing.assert_allclose(v.numpy(), single_state[k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    _assert_lora_b_moved(states[0], case)


def test_lora_fsdp_refuses_bf16_weights(train_corpus, tmp_path):  # noqa: F811
    argv = ["--device", "cpu",
            *_train_overrides(train_corpus, tmp_path / "run"),
            "training.mesh_shape=[2]", "training.use_lora=true",
            "training.shard_params=true", "model.param_dtype=bfloat16"]
    for rc, out in W.spawn("cli", tmp_path / "ranks", 2, {"argv": argv},
                           check=False):
        assert rc != 0
        assert "NotImplementedError: training.shard_params over decoder " \
            "layers of 2 dtypes" in out, out[-3000:]
