"""CTC encoder pre-training in the port against the JAX package on the CPU:
``ctc_greedy_decode`` on random logits, and ``pretrain_encoder.main`` of
both packages on the same corpus and weights (the run of
tests/test_end_to_end.py:162 with a 60 s dev recording, so that the dev
evaluation cuts it into two 30 s pieces): the per-step losses, the
exported weights (only the CTC head moves), the WER/CER metrics and the
prediction table; then the same run with the gradient clip binding, against
JAX's step with the frozen parameters' gradients zeroed, so that its
``clip_by_global_norm`` counts the CTC head's gradients alone, as the
port's does."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from safetensors.numpy import load_file

import torch_parity_utils  # noqa: F401  (caps torch's threads)
from ts_asr_whisper_tpu import pretrain_encoder as jpre
from ts_asr_whisper_tpu.config import load_config
from ts_asr_whisper_tpu.models.containers import WhisperContainer
from ts_asr_whisper_tpu.models.convert import params_to_hf, save_safetensors
from ts_asr_whisper_tpu.models.dicow import (dicow_encoder_forward,
                                             encoder_ctc_logits)
from ts_asr_whisper_tpu.models.losses import prepare_ctc_labels
from ts_asr_whisper_tpu.ops.ctc import ctc_greedy_decode as jax_greedy
from ts_asr_whisper_tpu.ops.ctc import ctc_loss_from_padded_labels
from ts_asr_whisper_tpu.training.optim import param_path_tree, path_matches
from ts_asr_whisper_tpu_torch import pretrain_encoder as tpre
from ts_asr_whisper_tpu_torch.config import load_config as port_load_config
from ts_asr_whisper_tpu_torch.data.synthetic import write_corpus
from ts_asr_whisper_tpu_torch.ops.ctc import ctc_greedy_decode

MODEL = {"vocab_size": 2000, "num_mel_bins": 80, "d_model": 32,
         "encoder_layers": 2, "decoder_layers": 2,
         "encoder_attention_heads": 2, "decoder_attention_heads": 2,
         "encoder_ffn_dim": 64, "decoder_ffn_dim": 64,
         "max_source_positions": 1500, "max_target_positions": 64}


@pytest.mark.parametrize("vocab", [3, 7, 50])
def test_ctc_greedy_decode_matches_jax(vocab):
    """Few classes make repeats, blanks and argmax ties (rounded logits)
    common."""
    rng = np.random.default_rng(vocab)
    logits = np.round(rng.standard_normal((4, 37, vocab)), 1).astype(
        np.float32)
    logits[1] = 0.0  # every frame a tie: argmax 0 everywhere
    for blank in (0, vocab - 1):
        ref = np.asarray(jax_greedy(jnp.asarray(logits), blank))
        out = ctc_greedy_decode(torch.from_numpy(logits), blank).numpy()
        np.testing.assert_array_equal(out, ref)


@pytest.fixture(scope="module")
def pre_corpus(tmp_path_factory):
    """Train: two 8 s two-speaker recordings (4 rows); dev: one 60 s
    recording (2 rows); a tiny model with the CTC head's bare
    self-attention and subsampling, weights saved by the JAX container."""
    from test_end_to_end import _cut, _make_recording, _sup, _write_manifest

    tmp = tmp_path_factory.mktemp("torch_pretrain")
    rng = np.random.default_rng(0)
    cuts = []
    for i in range(2):
        rec = _make_recording(tmp, f"train{i}", 8.0, rng)
        cuts.append(_cut(rec, f"train{i}_cut", [
            _sup(rec["id"], 0.5, 3.0, "hello world how are you", "spkA"),
            _sup(rec["id"], 4.0, 3.0, "fine thank you very much", "spkB")]))
    _write_manifest(tmp / "train_cutset.jsonl.gz", cuts)
    dev = write_corpus(tmp / "dev", durations=(60.0,), seed=3)
    model_dir = tmp / "model"
    model_dir.mkdir()
    (model_dir / "config.json").write_text(json.dumps(MODEL))
    corpus = {"train": tmp / "train_cutset.jsonl.gz", "dev": dev,
              "model": model_dir}
    # a Whisper checkpoint with the CTC head and no FDDTs, as pre-training
    # builds its model (pretrain_encoder.py:65-67)
    jc = WhisperContainer(load_config(_overrides(corpus, tmp / "x")
                                      + ["model.use_fddt=false"],
                                      n_devices=1), seed=7)
    save_safetensors(params_to_hf(jax.tree.map(np.asarray, jc.params),
                                  jc.model_config),
                     str(model_dir / "model.safetensors"))
    return corpus


def _overrides(corpus, out_dir, max_grad_norm=1e9):
    return [f"model.whisper_model={corpus['model']}",
            f"data.train_cutsets=[{corpus['train']}]",
            f"data.dev_cutsets=[{corpus['dev']}]",
            "data.use_timestamps=false", "data.train_text_norm=null",
            "model.ctc_weight=0.3", "model.pre_ctc_sub_sample=true",
            "model.additional_self_attention_layer=true",
            "model.dtype=float32", "training.pretrain_encoder=true",
            "training.max_steps=3", "training.overall_batch_size=0",
            "training.per_device_train_batch_size=2",
            "training.per_device_eval_batch_size=2",
            "training.learning_rate=3e-3", "training.warmup_steps=0",
            "training.logging_steps=1", "training.save_strategy=no",
            "training.dataloader_num_workers=1",
            # 1e9, no clip: the JAX step's global norm also counts the
            # frozen encoder's gradients, which the port never computes (a
            # deliberate divergence, pretrain_encoder.py's docstring;
            # test_pretrain_clip_counts_the_head_alone clips)
            f"training.max_grad_norm={max_grad_norm}",
            f"training.output_dir={out_dir}"]


def test_pretrain_matches_jax(pre_corpus, tmp_path, monkeypatch):
    jlosses, tlosses = [], []
    make_step = jpre.make_pretrain_step

    def recording_step(*args):
        step = make_step(*args)

        def run(params, opt_state, batch):
            params, opt_state, parts = step(params, opt_state, batch)
            jlosses.append(float(parts["loss"]))
            return params, opt_state, parts
        return run

    monkeypatch.setattr(jpre, "make_pretrain_step", recording_step)
    loss_fn = tpre.pretrain_loss
    monkeypatch.setattr(tpre, "pretrain_loss", lambda *a: tlosses.append(
        loss_fn(*a)) or tlosses[-1])
    jax_out, port_out = tmp_path / "jax", tmp_path / "port"
    ref = jpre.main(load_config(_overrides(pre_corpus, jax_out),
                                n_devices=1))
    out = tpre.main(port_load_config(_overrides(pre_corpus, port_out)),
                    torch.device("cpu"))

    assert len(tlosses) == len(jlosses) == 3
    np.testing.assert_allclose([float(x) for x in tlosses], jlosses,
                               rtol=1e-5)
    assert sorted(out) == sorted(ref) == ["eval_eval_cutset_cer",
                                          "eval_eval_cutset_wer"]
    for k, v in ref.items():
        np.testing.assert_allclose(out[k], v, rtol=1e-6, err_msg=k)
    # the same predictions, row for row
    jtab, ttab = (sorted(o.glob("eval_predictions_*.jsonl"))
                  for o in (jax_out, port_out))
    assert [p.name for p in ttab] == [p.name for p in jtab] and ttab
    assert ttab[0].read_text() == jtab[0].read_text()

    start = load_file(str(pre_corpus["model"] / "model.safetensors"))
    jsd, tsd = (load_file(str(o / "hf_export" / "model.safetensors"))
                for o in (jax_out, port_out))
    assert set(tsd) == set(jsd) == set(start)
    moved = set()
    for k, v in jsd.items():
        # Adam turns gradient rounding near its eps into steps of up to lr
        # size: the steps agree to 2% in norm (test_torch_train_step.py)
        step, ref_step = tsd[k] - start[k], v - start[k]
        assert np.linalg.norm(step - ref_step) <= \
            0.02 * np.linalg.norm(ref_step), k
        if step.any():
            moved.add(k)
    head = ("model.encoder.additional_self_attention_layer.",
            "model.encoder.lm_head.", "model.encoder.subsample_conv")
    assert moved and all(k.startswith(head) for k in moved)
    assert any(k.startswith(head[0]) for k in moved)


def _head_only_step(model_cfg, tx, num_prefix_tokens, norms, losses):
    """JAX's pre-training step (pretrain_encoder.py:45-63) with the frozen
    parameters' gradients set to zero before ``tx``: its
    ``clip_by_global_norm`` then counts the CTC head's gradients alone.
    Records each step's loss and that norm."""
    def loss_fn(params, batch):
        hidden = dicow_encoder_forward(params["encoder"], model_cfg,
                                       batch["input_features"], None)
        logits = encoder_ctc_logits(params["encoder"], model_cfg, hidden)
        labels = prepare_ctc_labels(batch["labels"], model_cfg,
                                    num_prefix_tokens)
        return ctc_loss_from_padded_labels(
            logits, labels, blank_id=model_cfg.ctc_vocab_size - 1)

    grad_fn = jax.jit(jax.value_and_grad(loss_fn))

    def step(params, opt_state, batch):
        loss, grads = grad_fn(params, batch)
        head = jax.tree.map(
            lambda p: path_matches(p, jpre.PRETRAIN_TRAINABLE),
            param_path_tree(params))
        grads = jax.tree.map(lambda g, m: g if m else jnp.zeros_like(g),
                             grads, head)
        losses.append(float(loss))
        norms.append(float(optax.global_norm(grads)))
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, {"loss": loss}
    return step


def test_pretrain_clip_counts_the_head_alone(pre_corpus, tmp_path,
                                            monkeypatch):
    """max_grad_norm 15, between the head's gradient norm at the first
    step (~10) and at the two later ones (~19, ~28): the first update is
    not clipped, the later ones are. (Adam is invariant to one rescale of
    every step's gradients, so only a clip that binds at some steps and not
    at others shows which norm it divides by.) The port's losses and
    exported weights against JAX's step clipped over the head's gradients
    alone (``_head_only_step``). The divergence from the JAX step as it is,
    whose norm also counts the frozen encoder's gradients, is ROADMAP
    queue 3's "Pre-training's gradient clip"."""
    norms, jlosses, tlosses = [], [], []
    monkeypatch.setattr(jpre, "make_pretrain_step",
                        lambda *a: _head_only_step(*a, norms, jlosses))
    loss_fn = tpre.pretrain_loss
    monkeypatch.setattr(tpre, "pretrain_loss", lambda *a: tlosses.append(
        loss_fn(*a)) or tlosses[-1])
    jax_out, port_out = tmp_path / "jax", tmp_path / "port"
    jpre.main(load_config(_overrides(pre_corpus, jax_out, 15.0),
                          n_devices=1))
    tpre.main(port_load_config(_overrides(pre_corpus, port_out, 15.0)),
              torch.device("cpu"))

    assert len(norms) == 3 and norms[0] < 15.0 < min(norms[1:]), norms
    np.testing.assert_allclose([float(x) for x in tlosses], jlosses,
                               rtol=1e-5)
    start = load_file(str(pre_corpus["model"] / "model.safetensors"))
    jsd, tsd = (load_file(str(o / "hf_export" / "model.safetensors"))
                for o in (jax_out, port_out))
    for k, v in jsd.items():
        # as test_pretrain_matches_jax: Adam's steps agree to 2% in norm
        step, ref_step = tsd[k] - start[k], v - start[k]
        assert np.linalg.norm(step - ref_step) <= \
            0.02 * np.linalg.norm(ref_step), k
