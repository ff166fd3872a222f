"""SE-DiCoW training in the port against the JAX package on the same bridged
weights and batch: one step's loss and every gradient, with the SCB gates
opened (a fresh gate is 0, and every SCB gradient but the gate's would be
exactly zero), so that the SCBs' and the enrollment stream's gradients carry
a signal; the preheat labels of se_dicow.yaml, ``encoder/ca_enrolls``
included; and the Trainer over preheat -> unfreeze -> base on enrollment
batches."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity_utils as U
from test_torch_train_step import NUM_PREFIX, _batch, _train_cfgs
from ts_asr_whisper_tpu.config import load_config
from ts_asr_whisper_tpu.models.dicow import dicow_forward, encoder_ctc_logits
from ts_asr_whisper_tpu.models.losses import dicow_loss
from ts_asr_whisper_tpu.parallel.mesh import make_mesh
from ts_asr_whisper_tpu.training import optim as JO
from ts_asr_whisper_tpu.training import trainer as JT
from ts_asr_whisper_tpu_torch.models.convert import state_dict_from_jax
from ts_asr_whisper_tpu_torch.training import optim as TO
from ts_asr_whisper_tpu_torch.training import trainer as TT

SE_PREHEAT = load_config(["+train=se_dicow", "model.reinit_encoder_from=null",
                          "data.dataset_weights=null", "aug.musan_root=null",
                          "data.enrollment_cutsets=[]",
                          "data.train_cutsets=[]", "data.dev_cutsets=[]",
                          "data.eval_cutsets=[]"],
                         n_devices=1).model.prefixes_to_preheat


def _se_pair(seed, scb_layers=2, gates=(0.6, -0.5)):
    """A pair with open SCB gates: the SCBs' cross-attention, FFN and the
    enrollment stream's stem and layers then reach the loss."""
    jcfg, params, tcfg, model = U.make_pair(
        seed=seed, use_enrollments=True, scb_layers=scb_layers,
        remove_timestamps_from_ctc=True)
    params["encoder"]["ca_enrolls"]["gate"] = jnp.asarray(
        np.array(gates[:scb_layers], np.float32)[:, None])
    model.load_state_dict(state_dict_from_jax(
        jax.tree.map(np.asarray, params), tcfg), strict=True)
    return jcfg, params, tcfg, model


def _se_batch(rng, cfg, b=2):
    batch = _batch(rng, cfg, b=b)
    batch["enroll_features"], batch["enroll_stno"] = U.encoder_inputs(rng,
                                                                      b=b)
    return batch


def _jax_loss(cfg, batch):
    def loss(params, enroll_features):
        dec_in = JT.shift_tokens_right(jnp.asarray(batch["labels"]),
                                       cfg.pad_token_id,
                                       cfg.decoder_start_token_id)
        logits, enc = dicow_forward(
            params, cfg, jnp.asarray(batch["input_features"]),
            jnp.asarray(batch["stno_mask"]), dec_in, enroll_features,
            jnp.asarray(batch["enroll_stno"]))
        return dicow_loss(logits, encoder_ctc_logits(params["encoder"], cfg,
                                                     enc),
                          jnp.asarray(batch["labels"]),
                          jnp.asarray(batch["upp_labels"]), cfg,
                          num_prefix_tokens=NUM_PREFIX)
    return loss


@pytest.mark.parametrize("remat", [False, True])
def test_one_step_loss_and_gradients_match_jax(remat):
    jcfg, params, tcfg, model = _se_pair(seed=4)
    batch = _se_batch(np.random.default_rng(5), jcfg)
    (jtotal, jparts), (jgrads, jg_enroll) = jax.value_and_grad(
        _jax_loss(jcfg, batch), argnums=(0, 1), has_aux=True)(
            params, jnp.asarray(batch["enroll_features"]))
    model.set_gradient_checkpointing(remat)
    tbatch = TT.to_device(batch, "cpu")
    assert {"enroll_features", "enroll_stno"} <= set(tbatch)
    tbatch["enroll_features"].requires_grad_()
    total, parts = TT.loss_fn(model, tcfg, tbatch, NUM_PREFIX)
    total.backward()
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
    for k in jparts:
        np.testing.assert_allclose(float(parts[k]), float(jparts[k]),
                                   rtol=1e-5, err_msg=k)
    ref = state_dict_from_jax(jax.tree.map(np.asarray, jgrads), tcfg)
    for name, p in model.named_parameters():
        # the CTC lattice's gradient (F.ctc_loss against the JAX scan)
        # differs by ~1e-4 of each tensor's scale (without the CTC term
        # the encoder's gradients agree to 3e-6); the sums over positions
        # leave that on small elements, so atol follows the tensor's scale
        r = ref[name].numpy()
        np.testing.assert_allclose(
            p.grad.numpy(), r, rtol=1e-4,
            atol=max(1e-5, 2e-4 * float(np.abs(r).max())), err_msg=name)
    # the SCBs and the enrollment stream carry a gradient
    for name, p in model.named_parameters():
        if ".ca_enrolls." in name:
            assert p.grad.abs().max() > 0, name
    g_enroll = tbatch["enroll_features"].grad.numpy()
    assert np.abs(g_enroll).max() > 0
    np.testing.assert_allclose(g_enroll, np.asarray(jg_enroll), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("preheat_only", [True, False])
def test_se_dicow_labels_match_jax(preheat_only):
    """se_dicow.yaml's preheat prefixes: the SCBs (``encoder/ca_enrolls``)
    train in the preheat group, as in JAX (optim.py:71-80)."""
    _, params, _, model = _se_pair(seed=0)
    params = jax.tree.map(np.asarray, params)
    cfg = load_config([], n_devices=1).training
    _, state = JO.build_optimizer(params, cfg, SE_PREHEAT, ["decoder"],
                                  preheat_only)
    labels = TO.param_labels(model, SE_PREHEAT, ["decoder"], preheat_only)
    inner = state[1].inner_states
    import optax

    codes = {"preheat": 0, "base": 1, "frozen": 2}
    tree = jax.tree.map(lambda _: 2, params)
    for label in ("preheat", "base"):
        if label in inner:
            tree = jax.tree.map(
                lambda c, m, lab=label: c if isinstance(m, optax.MaskedNode)
                else codes[lab], tree, inner[label].inner_state[0].mu,
                is_leaf=lambda x: isinstance(x, optax.MaskedNode))
    full = jax.tree.map(lambda p, x: np.full(np.shape(p), x), params, tree)
    ref = {k: int(v.flatten()[0])
           for k, v in state_dict_from_jax(full, model.cfg).items()}
    scb = [n for n in labels if ".ca_enrolls." in n]
    assert scb and all(labels[n] == "preheat" for n in scb)
    for name, label in labels.items():
        assert codes[label] == ref[name], name


def test_trainer_preheat_unfreeze_base_matches_jax(tmp_path):
    """4 micro-batches with enrollments in updates of 2 under se_dicow.yaml's
    preheat prefixes: the preheat update moves the SCBs, FDDTs and CTC head
    only, the base update everything but the decoder; the parameters
    follow the JAX Trainer's."""
    jcfg, params, tcfg, model = _se_pair(seed=6)
    jc, tc = _train_cfgs(tmp_path, "training.max_steps=4")
    jc.model.prefixes_to_preheat = tc.model.prefixes_to_preheat = \
        list(SE_PREHEAT)
    rng = np.random.default_rng(7)
    batches = [_se_batch(rng, jcfg) for _ in range(4)]
    start = state_dict_from_jax(jax.tree.map(np.array, params), tcfg)
    jt = JT.Trainer(jc, jcfg, params, num_prefix_tokens=NUM_PREFIX,
                    mesh=make_mesh([1]))
    jstate = jt.train(iter(batches))
    tt = TT.Trainer(tc, model, num_prefix_tokens=NUM_PREFIX)
    tstate = tt.train(iter(batches))
    assert tstate.step == jstate.step == 4 and tstate.phase == "base"
    ref = state_dict_from_jax(jax.tree.map(np.asarray, jstate.params), tcfg)
    moved = set()
    for name, p in model.named_parameters():
        out = p.detach().numpy()
        np.testing.assert_allclose(out, ref[name].numpy(), atol=1e-6,
                                   err_msg=name)
        if not np.array_equal(out, start[name].numpy()):
            moved.add(name)
    assert any(".ca_enrolls." in n for n in moved)
    assert not any(".decoder." in n for n in moved)
