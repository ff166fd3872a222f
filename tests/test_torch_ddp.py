"""The port's data-parallel fine-tune (DDP over gloo, 2 ranks on the CPU)
against one process and against the JAX package's single-process step, on
the same weights and the same global batch of 8 rows, of which rank 1's
hold far fewer label tokens than rank 0's (the decoder CE is one token mean
over the whole global batch: a mean per rank averaged over the ranks would
give another gradient). One preheat update, the unfreeze (where the DDP
wrapper is built again over the parameters unfrozen), then two base
updates; both ranks log the same losses, which equal the single-process
run's (rtol 1e-6) and the JAX Trainer's (rtol 1e-5, the port's train-step
bound), and end with bit-identical parameters. Cases: DiCoW v3 with and
without gradient accumulation, SE-DiCoW with one SCB, and LoRA."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mp_worker as W
import torch_parity_utils as U
from test_torch_lora import _lora_pair
from test_torch_se_dicow_train import SE_PREHEAT, _se_pair
from test_torch_train_step import NUM_PREFIX, _batch
from ts_asr_whisper_tpu.config import load_config
from ts_asr_whisper_tpu.parallel.mesh import make_mesh
from ts_asr_whisper_tpu.training import trainer as JT
from ts_asr_whisper_tpu_torch.models.convert import (lora_state_dict_from_jax,
                                                     state_dict_from_jax)
from ts_asr_whisper_tpu_torch.models.losses import dicow_loss
from ts_asr_whisper_tpu_torch.training import trainer as TT

GLOBAL_ROWS = 8
WORLD = 2
LOSS_KEYS = ("loss", "dec_loss", "ctc_loss")


def global_batches(rng, cfg, n, enroll=False):
    """``n`` global batches of 8 rows with 24 label columns; rows 4-7 (rank
    1's) keep 8 of them."""
    out = []
    for _ in range(n):
        b = _batch(rng, cfg, b=GLOBAL_ROWS)
        for k in ("labels", "upp_labels"):
            b[k][GLOBAL_ROWS // 2:, 8:] = -100
        if enroll:
            b["enroll_features"], b["enroll_stno"] = U.encoder_inputs(
                rng, b=GLOBAL_ROWS)
        out.append(b)
    return out


def overrides(out_dir, world, accum=1, *extra):
    """One preheat update, then two base updates, of micro-batches of
    8 / world rows (the settings of test_torch_train_step._train_cfgs)."""
    return ["model.dtype=float32", f"training.use_fddt_only_n_steps={accum}",
            "training.use_fddt_only_n_epochs=0",
            f"training.max_steps={3 * accum}",
            f"training.gradient_accumulation_steps={accum}",
            "training.warmup_steps=0", "training.learning_rate=3e-6",
            "training.eval_strategy=no", "training.save_strategy=no",
            "training.logging_steps=1",
            "model.params_to_keep_frozen_keywords=[decoder]",
            "training.adam_epsilon=1e-6", "training.fddt_lr_multiplier=3.0",
            "training.overall_batch_size=0",
            f"training.per_device_train_batch_size={GLOBAL_ROWS // world}",
            f"training.output_dir={out_dir}", *extra]


def make_case(name, tmp_path):
    """The JAX and port inputs of one case: (jax cfg, jax params, model
    kwargs, weights file, batches file, extra overrides, lora)."""
    kw = dict(remove_timestamps_from_ctc=True)
    extra, lora, accum = [], False, 1
    rng = np.random.default_rng(11)
    if name == "se_dicow":
        jcfg, params, _, _ = _se_pair(seed=6, scb_layers=1, gates=(0.6,))
        kw.update(use_enrollments=True, scb_layers=1)
        extra.append("model.prefixes_to_preheat=[" + ",".join(SE_PREHEAT)
                     + "]")
    elif name == "lora":
        jcfg, params, _, _ = _lora_pair(seed=3, b_shift=0.02)
        extra.append("training.use_lora=true")
        lora = True
    else:
        jcfg, params, _, _ = U.make_pair(seed=2, **kw)
        if name == "dicow_accum2":
            accum = 2
            extra.append("training.watch_grads=true")
    batches = global_batches(rng, jcfg, 3 * accum, enroll=name == "se_dicow")
    np_params = jax.tree.map(np.array, params)
    model_kw = {**U.TINY, **U.DICOW, **kw}
    tcfg = U.TorchConfig(**model_kw)
    sd = state_dict_from_jax({k: v for k, v in np_params.items()
                              if k != "lora"}, tcfg)
    if lora:
        sd.update(lora_state_dict_from_jax(np_params["lora"]))
    weights = tmp_path / "weights.pt"
    torch.save(sd, weights)
    batch_file = tmp_path / "batches.npz"
    np.savez(batch_file, **{f"{i}/{k}": v for i, b in enumerate(batches)
                            for k, v in b.items()})
    return dict(jcfg=jcfg, params=params, batches=batches, accum=accum,
                extra=extra, args={"model": model_kw, "weights": str(weights),
                                   "batches": str(batch_file), "lora": lora})


def jax_losses(case, tmp_path):
    """The JAX Trainer over the global batches, one process."""
    out = tmp_path / "jax"
    jc = load_config(overrides(out, 1, case["accum"], *case["extra"])
                     + ["training.mesh_shape=[1]"], n_devices=1)
    params = jax.tree.map(jnp.asarray, case["params"])
    JT.Trainer(jc, case["jcfg"], params, num_prefix_tokens=NUM_PREFIX,
               mesh=make_mesh([1])).train(iter(case["batches"]))
    return [json.loads(line) for line in
            (out / "metrics.jsonl").read_text().splitlines()]


def run_single(case, tmp_path):
    """The port's Trainer in this process over the whole global batches."""
    out = tmp_path / "single"
    args = dict(case["args"], ckpt=None, overrides=overrides(
        out, 1, case["accum"], *case["extra"]))
    states = tmp_path / "single_state"
    states.mkdir()
    res = W.run_train(str(states), 0, args)
    return res, torch.load(states / "state0.pt")


def run_ranks(case, tmp_path, *extra):
    """The port's Trainer on 2 ranks, each over its rows of the global
    batches."""
    out = tmp_path / "dp"
    args = dict(case["args"], overrides=overrides(
        out, WORLD, case["accum"], *case["extra"], *extra))
    res = W.spawn("train", tmp_path / "ranks", WORLD, args)
    states = [torch.load(tmp_path / "ranks" / f"state{r}.pt")
              for r in range(WORLD)]
    return res, states, out


def assert_losses_close(got, want, rtol, keys=LOSS_KEYS):
    assert [r["step"] for r in got] == [r["step"] for r in want]
    for o, r in zip(got, want):
        for k in keys:
            np.testing.assert_allclose(o[k], r[k], rtol=rtol,
                                       err_msg=f"step {r['step']} {k}")


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_loss_shares_sum_to_the_global_batch_loss(reduction):
    """The loss of each rank's rows as its share of the global batch's
    (models/losses.py: the global token count, the CTC term over the world
    under 'mean'): the shares of the two halves of a ragged batch add up to
    the whole batch's loss, parts and gradients."""
    _, _, cfg, model = U.make_pair(seed=4, ctc_loss_reduction=reduction)
    batch = TT.to_device(global_batches(np.random.default_rng(5), cfg,
                                        1)[0], "cpu")

    def loss_and_grads(rows, **kw):
        model.zero_grad()
        b = {k: v[rows] for k, v in batch.items()}
        labels = b["labels"].long()
        logits, enc = model(b["input_features"], b["stno_mask"],
                            TT.shift_tokens_right(
                                labels, cfg.pad_token_id,
                                cfg.decoder_start_token_id))
        total, parts = dicow_loss(logits, model.encoder.ctc_logits(enc),
                                  labels, b["upp_labels"].long(), cfg,
                                  num_prefix_tokens=NUM_PREFIX, **kw)
        total.backward()
        return ({k: v.detach() for k, v in parts.items()},
                [p.grad.clone() for p in model.parameters()])

    whole, whole_grads = loss_and_grads(slice(None))
    n_tokens = (batch["labels"] != -100).sum().float()
    halves = [loss_and_grads(rows, n_tokens=n_tokens, world=WORLD)
              for rows in (slice(0, 4), slice(4, 8))]
    for k, v in whole.items():
        np.testing.assert_allclose(float(halves[0][0][k] + halves[1][0][k]),
                                   float(v), rtol=1e-6, err_msg=k)
    for g, g0, g1 in zip(whole_grads, halves[0][1], halves[1][1]):
        np.testing.assert_allclose((g0 + g1).numpy(), g.numpy(), rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("name", ["dicow", "dicow_accum2", "se_dicow",
                                  "lora"])
def test_ddp_fine_tune_matches_one_process_and_jax(name, tmp_path):
    case = make_case(name, tmp_path)
    ranks, states, out = run_ranks(case, tmp_path)
    single, single_state = run_single(case, tmp_path)
    ref = jax_losses(case, tmp_path)
    r0, r1 = ranks
    assert r0["logged"] == r1["logged"]
    assert r0["phase"] == r1["phase"] == "base"
    assert r0["step"] == 3 * case["accum"] and r0["updates"] == 2
    assert_losses_close(r0["logged"], single["logged"], 1e-6)
    assert_losses_close(r0["logged"], ref, 1e-5)
    np.testing.assert_allclose([r["grad_norm"] for r in r0["logged"]],
                               [r["grad_norm"] for r in single["logged"]],
                               rtol=1e-5)
    if name == "dicow_accum2":  # the module norms of the JAX trainer
        assert sorted(r0["logged"][0]) == sorted(
            ["step", *[k for k in ref[0] if k not in ("step", "time")]])
    # the metrics stream is written once, by rank 0
    lines = (out / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 3 * case["accum"]
    # every parameter bit-identical on both ranks after the last update,
    # the ones unfrozen at the unfreeze too, and the single run's within
    # the rounding of the gradient sums
    moved = 0
    start = torch.load(case["args"]["weights"])
    for k, v in states[0].items():
        assert torch.equal(v, states[1][k]), k
        np.testing.assert_allclose(v.numpy(), single_state[k].numpy(),
                                   atol=1e-6, err_msg=k)
        moved += not torch.equal(v, start[k])
    # the encoder's layers train only after the unfreeze
    assert any(not torch.equal(states[0][k], start[k])
               for k in start if k.startswith("model.encoder.layers."))
    assert moved > 0
