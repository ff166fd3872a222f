"""The port's fine-tune step against the JAX package's on the same bridged
weights and batch: the loss and every gradient of one step, the Trainer
over preheat -> unfreeze -> base (with gradient accumulation), and the
``reinit_encoder_from`` / ``reinit_from`` weight loaders."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity_utils as U
from ts_asr_whisper_tpu.config import load_config
from ts_asr_whisper_tpu.models.containers import WhisperContainer as JaxContainer
from ts_asr_whisper_tpu.models.convert import params_to_hf, save_safetensors
from ts_asr_whisper_tpu.models.dicow import dicow_forward, encoder_ctc_logits
from ts_asr_whisper_tpu.models.losses import dicow_loss
from ts_asr_whisper_tpu.parallel.mesh import make_mesh
from ts_asr_whisper_tpu.training import trainer as JT
from ts_asr_whisper_tpu_torch.config import load_config as port_load_config
from ts_asr_whisper_tpu_torch.models.containers import WhisperContainer
from ts_asr_whisper_tpu_torch.models.convert import state_dict_from_jax
from ts_asr_whisper_tpu_torch.training import trainer as TT

NUM_PREFIX = 2


def _batch(rng, cfg, b=2, length=24):
    feats, stno = U.encoder_inputs(rng, b=b)
    labels = rng.integers(0, cfg.timestamp_begin + 300, (b, length))
    labels[:, :3] = [1994, 1995, 1996]
    labels[1, length - 6:] = -100
    upp = labels.copy()
    upp[(labels > 30) & (labels % 4 == 0)] += 1
    return {"input_features": feats, "stno_mask": stno, "labels": labels,
            "upp_labels": upp}


def _jax_loss(cfg, batch):
    """The JAX trainer's loss_fn (trainer.py:59-82) without its
    stop_gradient mask: every gradient is compared."""
    def loss(params):
        dec_in = JT.shift_tokens_right(jnp.asarray(batch["labels"]),
                                       cfg.pad_token_id,
                                       cfg.decoder_start_token_id)
        logits, enc = dicow_forward(params, cfg,
                                    jnp.asarray(batch["input_features"]),
                                    jnp.asarray(batch["stno_mask"]), dec_in)
        return dicow_loss(logits, encoder_ctc_logits(params["encoder"], cfg,
                                                     enc),
                          jnp.asarray(batch["labels"]),
                          jnp.asarray(batch["upp_labels"]), cfg,
                          num_prefix_tokens=NUM_PREFIX)
    return loss


@pytest.mark.parametrize("remat", [False, True])
def test_one_step_loss_and_gradients_match_jax(remat):
    jcfg, params, tcfg, model = U.make_pair(seed=0,
                                            remove_timestamps_from_ctc=True)
    batch = _batch(np.random.default_rng(1), jcfg)
    (jtotal, jparts), jgrads = jax.value_and_grad(
        _jax_loss(jcfg, batch), has_aux=True)(params)
    model.set_gradient_checkpointing(remat)
    total, parts = TT.loss_fn(model, tcfg, TT.to_device(batch, "cpu"),
                              NUM_PREFIX)
    total.backward()
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
    for k in jparts:
        np.testing.assert_allclose(float(parts[k]), float(jparts[k]),
                                   rtol=1e-5, err_msg=k)
    ref = state_dict_from_jax(jax.tree.map(np.asarray, jgrads), tcfg)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_loss_fn_blocks_with_the_global_token_count_sum_to_the_batch():
    """The batch taken in two blocks of one row, as two data-parallel ranks
    take it (each block's labels cut to its own longest row), with the
    global token count and ``world`` 2: the blocks' losses, parts and
    gradients sum to the JAX loss and gradients of the whole batch."""
    jcfg, params, tcfg, model = U.make_pair(seed=0,
                                            remove_timestamps_from_ctc=True)
    batch = _batch(np.random.default_rng(1), jcfg)
    (jtotal, jparts), jgrads = jax.value_and_grad(
        _jax_loss(jcfg, batch), has_aux=True)(params)
    tb = TT.to_device(batch, "cpu")
    n_tokens = (tb["labels"] != -100).sum().float()
    total, parts = 0.0, {}
    for i in range(2):
        block = {k: v[i:i + 1] for k, v in tb.items()}
        width = int((block["labels"] != -100).sum())
        for key in ("labels", "upp_labels"):
            block[key] = block[key][:, :width]
        t, p = TT.loss_fn(model, tcfg, block, NUM_PREFIX, n_tokens=n_tokens,
                          world=2)
        t.backward()
        total = total + float(t)
        parts = {k: parts.get(k, 0.0) + float(v) for k, v in p.items()}
    np.testing.assert_allclose(total, float(jtotal), rtol=1e-5)
    for k in jparts:
        np.testing.assert_allclose(parts[k], float(jparts[k]), rtol=1e-5,
                                   err_msg=k)
    ref = state_dict_from_jax(jax.tree.map(np.asarray, jgrads), tcfg)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_shift_tokens_right_matches():
    labels = np.array([[5, 6, 7, -100], [8, -100, -100, -100]])
    ref = np.asarray(JT.shift_tokens_right(jnp.asarray(labels), 3, 9))
    out = TT.shift_tokens_right(torch.from_numpy(labels), 3, 9).numpy()
    np.testing.assert_array_equal(out, ref)


def _train_cfgs(tmp_path, *extra):
    overrides = ["model.dtype=float32", "training.use_fddt_only_n_steps=2",
                 "training.use_fddt_only_n_epochs=0", "training.max_steps=6",
                 "training.gradient_accumulation_steps=2",
                 "training.warmup_steps=0", "training.learning_rate=3e-6",
                 "training.eval_strategy=no", "training.save_strategy=no",
                 "training.logging_steps=1", "training.mesh_shape=[1]",
                 "model.params_to_keep_frozen_keywords=[decoder]",
                 # Adam turns the rounding noise of gradients near its eps
                 # into steps of up to lr size: eps 1e-6 and a preheat lr of
                 # 9e-6 keep that noise under the 1e-6 compared
                 "training.adam_epsilon=1e-6",
                 "training.fddt_lr_multiplier=3.0", *extra]
    return (load_config(overrides + [f"training.output_dir={tmp_path}/j"],
                        n_devices=1),
            port_load_config(overrides + [f"training.output_dir={tmp_path}/t"],
                             n_devices=1))


def test_trainer_preheat_unfreeze_base_matches_jax(tmp_path):
    """6 micro-batches in updates of 2: one preheat update, the unfreeze
    with a fresh optimizer, two base updates; the parameters and the logged
    losses follow the JAX Trainer."""
    jcfg, params, tcfg, model = U.make_pair(seed=2)
    jc, tc = _train_cfgs(tmp_path, "training.watch_grads=true")
    rng = np.random.default_rng(3)
    batches = [_batch(rng, jcfg) for _ in range(6)]
    # copied before the JAX step donates the buffers
    start = state_dict_from_jax(jax.tree.map(np.array, params), tcfg)
    jt = JT.Trainer(jc, jcfg, params, num_prefix_tokens=NUM_PREFIX,
                    mesh=make_mesh([1]))
    jstate = jt.train(iter(batches))
    tt = TT.Trainer(tc, model, num_prefix_tokens=NUM_PREFIX)
    assert tt.state.phase == "preheat"
    tstate = tt.train(iter(batches))
    assert tstate.step == jstate.step == 6 and tstate.phase == "base"
    ref = state_dict_from_jax(jax.tree.map(np.asarray, jstate.params), tcfg)
    for name, p in model.named_parameters():
        out = p.detach().numpy()
        np.testing.assert_allclose(out, ref[name].numpy(), atol=1e-6,
                                   err_msg=name)
        step, ref_step = out - start[name].numpy(), (ref[name] -
                                                     start[name]).numpy()
        if ".decoder." in name:  # frozen throughout
            assert not step.any() and not ref_step.any(), name
        else:  # every other tensor moved, as in JAX (2% in norm)
            assert np.linalg.norm(step - ref_step) <= \
                0.02 * np.linalg.norm(ref_step) > 0, name
    jlog, tlog = ([json.loads(line) for line in
                   (tmp_path / side / "metrics.jsonl").read_text()
                   .splitlines()] for side in ("j", "t"))
    assert [r["step"] for r in tlog] == [r["step"] for r in jlog]
    for r, o in zip(jlog, tlog):
        assert sorted(o) == sorted(r)  # watch_grads: the same module keys
        for k in ("loss", "dec_loss", "ctc_loss"):
            np.testing.assert_allclose(o[k], r[k], rtol=1e-5)
        for k in r:  # gradients at rtol 1e-4 on weights already ~1e-7 apart
            if k.startswith("grad_norm"):
                np.testing.assert_allclose(o[k], r[k], rtol=1e-3,
                                           atol=1e-7, err_msg=k)
    assert tt.tx.inner.count == 2  # two base updates after the unfreeze


def _model_dir(tmp_path, seed):
    d = tmp_path / f"model{seed}"
    d.mkdir()
    cfg = {**{k: U.TINY[k] for k in (
        "vocab_size", "num_mel_bins", "d_model", "encoder_layers",
        "decoder_layers", "encoder_attention_heads",
        "decoder_attention_heads", "encoder_ffn_dim", "decoder_ffn_dim",
        "max_target_positions")}, "max_source_positions": 1500}
    (d / "config.json").write_text(json.dumps(cfg))
    return d


@pytest.mark.parametrize("loader", ["reinit_encoder_from", "reinit_from"])
def test_reinit_loaders_match_jax(tmp_path, loader):
    """Both containers start from the same weights, then load another
    checkpoint: an encoder-only file with bare keys (FDDT keys filtered out)
    or a full one."""
    model_dir = _model_dir(tmp_path, 0)
    overrides = [f"model.whisper_model={model_dir}",
                 "training.decode_only=true"]
    jcfg = load_config(overrides, n_devices=1)
    first, other = JaxContainer(jcfg, seed=0), JaxContainer(jcfg, seed=1)
    sd = params_to_hf(jax.tree.map(np.asarray, first.params),
                      first.model_config)
    save_safetensors(sd, str(model_dir / "model.safetensors"))
    other_sd = params_to_hf(jax.tree.map(np.asarray, other.params),
                            other.model_config)
    path = tmp_path / "other.safetensors"
    if loader == "reinit_encoder_from":
        other_sd = {k.removeprefix("model.encoder."): v
                    for k, v in other_sd.items()
                    if k.startswith("model.encoder.")}
    save_safetensors(other_sd, str(path))
    jc = JaxContainer(jcfg, seed=0)
    tc = WhisperContainer(port_load_config(overrides, n_devices=1),
                          torch.device("cpu"), seed=5)
    getattr(jc, loader)(str(path))
    getattr(tc, loader)(str(path))
    ref = state_dict_from_jax(jax.tree.map(np.asarray, jc.params),
                              tc.model_config)
    out = tc.model.state_dict()
    assert set(out) == set(ref)
    changed = 0
    for k, v in ref.items():
        np.testing.assert_array_equal(out[k].numpy(), v.numpy(), err_msg=k)
        changed += not np.array_equal(v.numpy(), sd[k])
    assert changed > 0
    if loader == "reinit_encoder_from":  # FDDTs and decoder kept
        for k in ref:
            if "fddt" in k or ".decoder." in k or k == "proj_out.weight":
                np.testing.assert_array_equal(out[k].numpy(), sd[k],
                                              err_msg=k)
    assert dataclasses.asdict(tc.cfg.model) == dataclasses.asdict(jcfg.model)
