"""The port's tensor parallelism (parallel/tensor.py, the ``model`` mesh
axis) module by module, on the CPU over gloo:

- ``tp_dim`` gives the JAX package's placement for every parameter: the
  ``param_shardings(..., tp_axis='model')`` spec of each JAX leaf, carried
  through ``state_dict_from_jax``, equals the port's dim leaf by leaf
  (DiCoW with the CTC head's bare attention or its extra layer, SE-DiCoW's
  SCBs, LoRA);
- ``shard_state_dict`` slices by that dim, and ``gather_state_dict`` over 2
  live ranks gives the whole state dict back bit for bit;
- an ``Attention``, an ``EncoderLayer``, a decoder layer and an SCB sliced
  over 2 ranks equal the whole module's output, input gradients and
  parameter gradients (this rank's slice) at rtol 1e-6 in fp64, 2e-6 in
  fp32 (the partial products add up in another order) and at bf16
  rounding in bf16;
- a checkpoint saved by a fine-tune at mesh [1, 2] resumes at [1, 1] and at
  [2, 1] to the same parameters;
- the fine-tune's loading path at mesh [2, 2] with every augmentation on:
  ``bs * world`` rows a global batch, split over ``data``; the model peers
  of a data coordinate receive the same batches although their own loaders
  augment differently, and the two data coordinates read different rows.

- ``torchrun`` at [1, 2] through the CLI, with a dev evaluation on the
  gathered copy, checkpoints, the best model reloaded, the export and a
  test evaluation, gives the single-process run's metrics and weights.

The fine-tunes against one process and the JAX Trainer on the same mesh
are tests/test_torch_tp_train.py."""

import json
import sys

import jax
import numpy as np
import pytest
import torch

import torch_mp_worker as W
import torch_parity_utils as U
from test_torch_ddp import overrides
from test_torch_dist import _cli, _train_argv, single_fine_tune  # noqa: F401
from test_torch_end_to_end import (MODEL, _train_overrides,  # noqa: F401
                                   train_corpus)
from test_torch_tp_train import _case, _mesh_overrides, run_mesh
from ts_asr_whisper_tpu.models.config import DiCoWConfig as JaxConfig
from ts_asr_whisper_tpu.models.dicow import init_dicow
from ts_asr_whisper_tpu.parallel.mesh import make_mesh, param_shardings
from ts_asr_whisper_tpu.training.lora import init_lora
from ts_asr_whisper_tpu_torch.models.convert import (lora_state_dict_from_jax,
                                                     state_dict_from_jax)
from ts_asr_whisper_tpu_torch.models.dicow import DiCoW
from ts_asr_whisper_tpu_torch.parallel.tensor import shard_state_dict, tp_dim

KINDS = {"dicow": {},
         "additional_layer": dict(additional_layer=True,
                                  additional_self_attention_layer=False),
         "se_dicow": dict(use_enrollments=True, scb_layers=1),
         "lora": {}}


def _placement_code(sharding, ndim):
    """0 whole, 1 column (the model axis on the kernel's out dim, or a
    bias's only dim), 2 row (on the kernel's in dim)."""
    dims = list(sharding.spec) + [None] * (ndim - len(sharding.spec))
    if dims and dims[-1] == "model":
        return 1
    if ndim >= 2 and dims[-2] == "model":
        return 2
    assert "model" not in dims, sharding.spec
    return 0


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_tp_dim_gives_the_jax_placement(kind):
    kw = {**U.TINY, **U.DICOW, **KINDS[kind]}
    params = init_dicow(jax.random.PRNGKey(0), JaxConfig(**kw))
    if kind == "lora":
        params = dict(params, lora=init_lora(jax.random.PRNGKey(1), params))
    specs = param_shardings(params, make_mesh((1, 2), ("data", "model")),
                            tp_axis="model")
    codes = jax.tree.map(
        lambda p, s: np.full(p.shape, _placement_code(s, p.ndim),
                             np.float32), params, specs)
    tcfg = U.TorchConfig(**kw)
    sd = state_dict_from_jax({k: v for k, v in codes.items()
                              if k != "lora"}, tcfg)
    if kind == "lora":
        sd.update(lora_state_dict_from_jax(codes["lora"]))
    model = DiCoW(tcfg)
    if kind == "lora":
        from ts_asr_whisper_tpu_torch.training.lora import init_lora as tl

        tl(model, torch.Generator().manual_seed(0))
    assert set(sd) == set(model.state_dict())
    want_dim = {0: None, 1: 0, 2: 1}
    counts = {0: 0, 1: 0, 2: 0}
    for name, v in sd.items():
        code = np.unique(np.asarray(v))
        assert code.size == 1, name
        assert tp_dim(name) == want_dim[int(code[0])], name
        counts[int(code[0])] += 1
    # q/k/v/fc1 kernels and q/v/fc1 biases, out_proj/fc2 kernels, per
    # attention and MLP of every scope
    assert counts[1] > 0 and counts[2] > 0


def test_shard_state_dict_slices_whole_heads():
    _, _, _, model = U.make_pair(seed=5)
    full = model.state_dict()
    parts = [shard_state_dict(full, m, 2) for m in range(2)]
    for name, v in full.items():
        dim = tp_dim(name)
        if dim is None:
            assert all(p[name] is v for p in parts), name
            continue
        assert all(p[name].shape[dim] * 2 == v.shape[dim] for p in parts)
        assert torch.equal(torch.cat([p[name] for p in parts], dim), v), name
    q = "model.encoder.layers.0.self_attn.q_proj.weight"
    # 2 heads of 64 over 2 ranks: one whole head each
    assert parts[1][q].shape == (64, 128)
    assert torch.equal(parts[1][q], full[q][64:])
    assert shard_state_dict(full, 0, 1) == full


@pytest.fixture(scope="module")
def module_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_modules")
    return W.spawn("tp_modules", tmp, 2, {
        "d": 128, "heads": 4, "ffn": 256, "t": 40,
        "model": {**U.TINY, **U.DICOW}})


def test_gathered_state_dict_round_trips(module_runs):
    for r in module_runs:
        assert r["round_trip"] is True
        assert r["local_shapes"][
            "model.encoder.layers.0.fc2.weight"] == [128, 128]
        assert r["local_shapes"][
            "model.decoder.layers.1.encoder_attn.k_proj.weight"] == [64, 128]


# |sliced - whole| <= tol (max|whole| + |whole|) elementwise: rtol tol with
# an atol of tol times the tensor's largest magnitude. The partial products
# add up in another order: fp64 holds the sliced arithmetic at 1e-6 (the
# layer norms still compute in fp32); in fp32 that order moves the SCB's
# ffn.0 weight gradient (80 rows of products of the attention output) by
# up to 1.04e-6; in bf16 each side rounds its products and activations to
# bf16 where the other may not round alike
TOLS = {"float64": 1e-6, "float32": 2e-6, "bfloat16": 3e-2}


@pytest.mark.parametrize("dtype", sorted(TOLS))
@pytest.mark.parametrize("kind", ["attention", "encoder_layer",
                                  "decoder_layer", "scb"])
def test_sliced_module_equals_the_whole_module(module_runs, kind, dtype):
    tol = TOLS[dtype]
    for r in module_runs:
        res = r[f"{kind}/{dtype}"]
        assert res["out"] <= tol and res["dx"] <= tol, res
        assert res["sliced"], kind
        for name, err in res["params"].items():
            assert err <= tol, (name, err)


def _aug_overrides(corpus, out, mesh):
    """The base fine-tune with every augmentation drawn at each row."""
    return [o for o in _train_overrides(corpus, out)
            if not o.startswith(("aug.", "training.mesh_shape",
                                 "training.per_device_train_batch_size"))] + [
        "aug.stno_gaussian_noise_var=0.1", "aug.stno_gaussian_noise_prob=1.0",
        "aug.stno_segment_augment_prob=1.0",
        "aug.stno_segment_change_prob=0.1", "aug.stno_min_segment_length=5",
        "aug.stno_max_segment_length=50", "aug.spec_aug_prob=1.0",
        "training.per_device_train_batch_size=1",
        f"training.mesh_shape=[{mesh[0]},{mesh[1]}]",
        "training.mesh_axis_names=[data,model]"]


def test_model_peers_receive_the_same_augmented_batches(train_corpus,
                                                        tmp_path):
    ranks = W.spawn("batches", tmp_path / "ranks", 4, {
        "overrides": _aug_overrides(train_corpus, tmp_path / "exp", (2, 2)),
        "n": 3, "data": 2}, timeout=180)
    # rank = d * tp + m: ranks 0, 1 hold data coordinate 0, ranks 2, 3 hold 1
    assert [r["data_rank"] for r in ranks] == [0, 0, 1, 1]
    for r in ranks:
        assert len(r["received"]) == 3
        # a global batch of 1 x 4 rows, 2 a data coordinate
        assert r["rows"] == 1 and r["local_rows"] == 2
    for a, b in ((0, 1), (2, 3)):
        assert ranks[a]["received"] == ranks[b]["received"]
        # a loader of the peer's own augments the same rows otherwise
        assert ranks[b]["own"] != ranks[a]["received"]
    assert not set(ranks[0]["received"]) & set(ranks[2]["received"])


@pytest.mark.parametrize("shape", [(1, 1), (2, 1)])
def test_checkpoint_at_1x2_resumes_on_another_mesh(shape, tmp_path,
                                                   tmp_path_factory):
    ckpt = tmp_path_factory.getbasetemp() / "tp_ckpt"
    if not (ckpt / "latest").exists():
        # tests/test_torch_tp_train.py's [1, 2] DDP fine-tune, saving it
        case = dict(_case("dicow", tmp_path_factory))
        case["args"] = dict(case["args"], ckpt=str(ckpt))
        run_mesh(case, tmp_path / "saver", (1, 2),
                 "training.shard_params=false")
    saved = torch.load(ckpt / "step_3" / "state.pt")["params"]
    case = _case("dicow", tmp_path_factory)
    world = shape[0] * shape[1]
    args = dict(case["args"], ckpt=str(ckpt), overrides=overrides(
        tmp_path / "resume", world, 1, *_mesh_overrides(shape)))
    ranks = W.spawn("resume", tmp_path / "ranks", world, args)
    for r in range(world):
        resumed = torch.load(tmp_path / "ranks" / f"resumed{r}.pt")
        assert set(resumed) == set(saved)
        for k, v in saved.items():
            assert torch.equal(resumed[k], v), k
        assert ranks[r]["step"] == 3 and ranks[r]["phase"] == "base"
        assert ranks[r]["local_heads"] == 2


def test_torchrun_tp_fine_tune_matches_one_process(train_corpus,
                                                   single_fine_tune,
                                                   tmp_path):
    """test_torch_dist's end-to-end fine-tune (dev evaluation at step 3,
    checkpoints, the best model reloaded, the export, the test evaluation)
    at mesh [1, 2]: micro-batch 1 on each of 2 ranks is a global batch of
    2 rows, all of them on the one data coordinate, as the single run's
    micro-batch of 2."""
    from safetensors.numpy import load_file

    out = tmp_path / "exp"
    argv = [o for o in _train_argv(train_corpus, out, 1)
            if o != "training.mesh_shape=[1]"] + _mesh_overrides((1, 2))
    err = _cli([sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", "2", "-m", "ts_asr_whisper_tpu_torch",
                "--device", "cpu", *argv], tmp_path, timeout=180)
    assert "rank=1/2" in err and "Unfreezing at step 2" in err
    assert "Reloading best checkpoint" in err
    logs = [[json.loads(line) for line in
             (d / "metrics.jsonl").read_text().splitlines()]
            for d in (single_fine_tune, out)]
    assert [r["step"] for r in logs[1]] == [r["step"] for r in logs[0]] \
        == [1, 2, 3, 3]
    for r, o in zip(logs[0][:3], logs[1][:3]):
        for k in ("loss", "dec_loss", "ctc_loss"):
            np.testing.assert_allclose(o[k], r[k], rtol=1e-5, err_msg=k)
        # the row-parallel sums move the CTC logits by ~4e-7 (relative);
        # F.ctc_loss's fp32 backward over 375 frames (occupancies close to
        # the softmax, with cancellation) turns that into ~1.6e-4 of its
        # gradient, 1.06e-4 of the norm at step 1
        np.testing.assert_allclose(o["grad_norm"], r["grad_norm"], rtol=2e-4)
    assert logs[1][3].keys() == logs[0][3].keys()
    for k, v in logs[0][3].items():
        if k != "time":
            np.testing.assert_allclose(logs[1][3][k], v, rtol=1e-6,
                                       err_msg=k)
    assert len(list(out.rglob("all_session_wer.csv"))) == 2
    want = load_file(str(single_fine_tune / "hf_export" /
                         "model.safetensors"))
    got = load_file(str(out / "hf_export" / "model.safetensors"))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)
