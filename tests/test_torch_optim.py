"""The port's optimizer against the JAX package's optax chain: the
learning-rate schedule count for count, the label and trainable sets of
each phase through the weight bridge, the parameters after updates on the
same gradients, and gradient accumulation as ``optax.MultiSteps``."""

import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch

import torch_parity_utils as U
from ts_asr_whisper_tpu.config import load_config
from ts_asr_whisper_tpu.training import optim as JO
from ts_asr_whisper_tpu_torch.models.convert import state_dict_from_jax
from ts_asr_whisper_tpu_torch.training import optim as TO

PREHEAT = load_config([], n_devices=1).model.prefixes_to_preheat
FROZEN = ["decoder"]


def _training_cfg(**kw):
    cfg = load_config([], n_devices=1).training
    return dataclasses.replace(cfg, **kw)


@pytest.mark.parametrize("kind", ["cosine", "linear", "constant"])
@pytest.mark.parametrize("warmup", [0, 5])
def test_schedule_equals_optax_at_every_count(kind, warmup):
    cfg = _training_cfg(lr_scheduler_type=kind, warmup_steps=warmup,
                        max_steps=40, learning_rate=3e-4)
    ref = JO.make_lr_schedule(cfg, 2e-3)
    out = TO.make_lr_schedule(cfg, 2e-3)
    # optax evaluates the schedule in fp32, the port in float64: the
    # cosine's tail, near 0, differs by a few fp32 ulps of the peak
    for count in range(0, 50):
        np.testing.assert_allclose(out(count), float(ref(count)), rtol=1e-6,
                                   atol=1e-6 * 2e-3, err_msg=str(count))


def _mapped(params, tree, cfg):
    """A pytree of per-leaf values -> {state_dict name: value} through the
    weight bridge (each leaf broadcast to its parameter's shape)."""
    full = jax.tree.map(lambda p, x: np.full(np.shape(p), x), params, tree)
    return {k: v.numpy() for k, v in state_dict_from_jax(full, cfg).items()}


def _jax_labels(params, cfg, preheat_only):
    """Labels as the JAX chain applies them: a parameter belongs to the
    label whose Adam state holds a moment for it."""
    _, state = JO.build_optimizer(params, cfg, PREHEAT, FROZEN, preheat_only)
    inner = state[1].inner_states
    labels = jax.tree.map(lambda _: "frozen", params)
    for label in ("preheat", "base"):
        if label not in inner:
            continue
        mu = inner[label].inner_state[0].mu
        labels = jax.tree.map(
            lambda lab, m: label if not isinstance(m, optax.MaskedNode)
            else lab, labels, mu,
            is_leaf=lambda x: isinstance(x, optax.MaskedNode))
    return labels


@pytest.mark.parametrize("preheat_only", [True, False])
def test_labels_and_trainable_sets_match_jax(preheat_only):
    _, params, _, model = U.make_pair()
    params = jax.tree.map(np.asarray, params)
    cfg = _training_cfg()
    codes = {"preheat": 0, "base": 1, "frozen": 2}
    ref = _mapped(params, jax.tree.map(
        codes.get, _jax_labels(params, cfg, preheat_only)), model.cfg)
    mask = _mapped(params, JO.trainable_mask(params, PREHEAT, FROZEN,
                                             preheat_only), model.cfg)
    labels = TO.param_labels(model, PREHEAT, FROZEN, preheat_only)
    trainable = TO.trainable_mask(model, PREHEAT, FROZEN, preheat_only)
    assert set(labels) == {n for n, _ in model.named_parameters()}
    for name in labels:
        assert np.all(ref[name] == codes[labels[name]]), name
        assert np.all(mask[name] == trainable[name]), name
    assert ("preheat" in labels.values()) and (
        preheat_only == ("base" not in labels.values()))


def _grads(params, rng, labels):
    """Random gradients; exact zeros for frozen parameters (the JAX step's
    stop_gradient)."""
    return jax.tree.map(
        lambda p, lab: np.zeros_like(p) if lab == "frozen"
        else rng.standard_normal(p.shape).astype(np.float32) * 0.1,
        params, labels)


def _port_grads(model, tx, grads_sd):
    names = {id(p): n for n, p in model.named_parameters()}
    return [torch.from_numpy(np.array(grads_sd[names[id(p)]]))
            for p in tx.params]


def _assert_same(model, params, atol=1e-8):
    """rtol 1e-6; the atol covers parameters near 0, and the fp32 schedule
    and global norm of optax (a few ulps of an update of ~1e-3)."""
    ref = state_dict_from_jax(jax.tree.map(np.asarray, params), model.cfg)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                   rtol=1e-6, atol=atol, err_msg=name)


@pytest.mark.parametrize("preheat_only,kw,atol", [
    (True, {}, 1e-8),
    (False, {"weight_decay": 0.01, "max_grad_norm": 0.5}, 1e-8),
    # a first moment stored in bf16 rounds the other way where its fp32
    # value differs by an ulp across a rounding tie (~1 element in 10^4):
    # there the update moves by a few bf16 ulps (0.4% each) of a preheat
    # update of 1e-3
    (False, {"adam_mu_dtype": "bfloat16", "warmup_steps": 2}, 3e-5),
])
def test_three_updates_equal_optax(preheat_only, kw, atol):
    _, params, _, model = U.make_pair(seed=1)
    params = jax.tree.map(np.asarray, params)
    # preheat lr 1e-3 (x100), base 1e-5
    kw = {"warmup_steps": 0, **kw}
    cfg = _training_cfg(learning_rate=1e-5, max_steps=10,
                        lr_scheduler_type="cosine", **kw)
    jtx, jstate = JO.build_optimizer(params, cfg, PREHEAT, FROZEN,
                                     preheat_only)
    labels = _jax_labels(params, cfg, preheat_only)
    ttx, _ = TO.build_optimizer(model, cfg, PREHEAT, FROZEN, preheat_only)
    rng = np.random.default_rng(2)
    for _ in range(3):
        grads = _grads(params, rng, labels)
        updates, jstate = jtx.update(grads, jstate, params)
        params = optax.apply_updates(params, updates)
        gsd = {k: v.numpy() for k, v in state_dict_from_jax(
            grads, model.cfg).items()}
        ttx.step(_port_grads(model, ttx, gsd))
        _assert_same(model, params, atol)
    assert ttx.count == 3
    frozen = [n for n, p in model.named_parameters() if not p.requires_grad]
    assert bool(frozen) == (preheat_only or bool(FROZEN))


def test_accumulation_follows_multisteps():
    _, params, _, model = U.make_pair(seed=3)
    params = jax.tree.map(np.asarray, params)
    cfg = _training_cfg(learning_rate=1e-5, warmup_steps=0, max_steps=10,
                        gradient_accumulation_steps=2)
    jtx, _ = JO.build_optimizer(params, cfg, PREHEAT, FROZEN, False)
    jtx = optax.MultiSteps(jtx, 2)
    jstate = jtx.init(params)
    labels = _jax_labels(params, cfg, False)
    ttx, _ = TO.build_optimizer(model, cfg, PREHEAT, FROZEN, False)
    assert isinstance(ttx, TO.MultiSteps) and ttx.k == 2
    rng = np.random.default_rng(4)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    for micro in range(4):
        grads = _grads(params, rng, labels)
        updates, jstate = jtx.update(grads, jstate, params)
        params = optax.apply_updates(params, updates)
        gsd = {k: v.numpy() for k, v in state_dict_from_jax(
            grads, model.cfg).items()}
        ttx.step(_port_grads(model, ttx, gsd))
        _assert_same(model, params)
        # the inner optimizer counts updates, not micro-batches
        assert ttx.inner.count == (micro + 1) // 2
        moved = any(not torch.equal(p, before[n])
                    for n, p in model.named_parameters())
        assert moved == (micro >= 1)
