"""The remat policies of the port's gradient checkpointing
(``training.remat_policy``: models/whisper.py::remat_context,
models/dicow.py::DiCoWEncoder._remat_layer) on the CPU:
'dots' and 'attn' give the loss and gradients of 'full' bit for bit (a
saved tensor equals its recompute) and of the JAX package within the
parity tolerance, on DiCoW and on SE-DiCoW; 'attn' replays no flash forward
in the backward; the operators 'dots' sees and saves."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import checkpoint as ckpt

import torch_parity_utils as U
from test_torch_se_dicow_train import _jax_loss, _se_batch, _se_pair
from test_torch_train_step import NUM_PREFIX
from ts_asr_whisper_tpu_torch.models import whisper as W
from ts_asr_whisper_tpu_torch.models.convert import state_dict_from_jax
from ts_asr_whisper_tpu_torch.ops import attention as A
from ts_asr_whisper_tpu_torch.training import trainer as TT

POLICIES = ("dots", "attn")


def _grads(model, batch, policy):
    """Loss and {name: grad} of one step under ``policy`` (None: no
    checkpointing)."""
    model.set_gradient_checkpointing(policy is not None, policy or "full")
    model.zero_grad(set_to_none=True)
    total, _ = TT.loss_fn(model, model.cfg, TT.to_device(batch, "cpu"),
                          NUM_PREFIX)
    total.backward()
    return total.detach(), {n: p.grad.clone()
                            for n, p in model.named_parameters()}


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_gives_the_loss_and_gradients_of_full(policy):
    """SE-DiCoW (FDDT layers, the SCB region outside the checkpoints, the
    CTC head) against 'full', exactly, and against JAX."""
    jcfg, params, tcfg, model = _se_pair(seed=8)
    batch = _se_batch(np.random.default_rng(9), jcfg)
    ref_loss, ref = _grads(model, batch, "full")
    loss, grads = _grads(model, batch, policy)
    assert torch.equal(loss, ref_loss)
    for name, g in grads.items():
        assert torch.equal(g, ref[name]), name
    (jtotal, _), (jgrads, _) = jax.value_and_grad(
        _jax_loss(jcfg, batch), argnums=(0, 1), has_aux=True)(
            params, jnp.asarray(batch["enroll_features"]))
    np.testing.assert_allclose(float(loss), float(jtotal), rtol=1e-5)
    jref = state_dict_from_jax(jax.tree.map(np.asarray, jgrads), tcfg)
    for name, g in grads.items():
        r = jref[name].numpy()  # tolerance: test_torch_se_dicow_train.py
        np.testing.assert_allclose(
            g.numpy(), r, rtol=1e-4,
            atol=max(1e-5, 2e-4 * float(np.abs(r).max())), err_msg=name)


def _flash_calls(monkeypatch, model, batch, policy):
    calls = []
    fwd = A.flash_mha_fwd
    monkeypatch.setattr(A, "flash_mha_fwd",
                        lambda *a, **kw: calls.append(1) or fwd(*a, **kw))
    _grads(model, batch, policy)
    return len(calls)


def test_attn_policy_replays_no_flash_forward(monkeypatch):
    """DiCoW: 2 checkpointed encoder layers and the CTC head's bare
    self-attention (not checkpointed). 'full' and 'dots' run each layer's
    flash forward again in the backward, 'attn' takes the saved (out,
    lse)."""
    _, _, _, model = U.make_pair(seed=3, remove_timestamps_from_ctc=True)
    batch = _se_batch(np.random.default_rng(4), model.cfg)
    del batch["enroll_features"], batch["enroll_stno"]
    layers = model.cfg.encoder_layers
    counts = {p: _flash_calls(monkeypatch, model, batch, p)
              for p in (None, "full", "dots", "attn")}
    assert counts == {None: layers + 1, "full": 2 * layers + 1,
                      "dots": 2 * layers + 1, "attn": layers + 1}


def test_policies_see_and_save_these_operators(monkeypatch):
    """Record what the selective-checkpoint policy is asked about in one
    step: under 'dots' the linears reach it as ``aten.addmm`` (with bias)
    and ``aten.mm`` (k_proj), which it saves, and the attention's products
    as ``bmm``, which it does not; 'attn' splits the encoder's layers
    around the attention core instead and asks no policy at all."""
    seen = {}
    make = W.create_selective_checkpoint_contexts

    def recording(policy_fn, *args, **kwargs):
        def wrapped(ctx, func, *a, **kw):
            out = policy_fn(ctx, func, *a, **kw)
            seen.setdefault(func, set()).add(out)
            return out
        return make(wrapped, *args, **kwargs)

    monkeypatch.setattr(W, "create_selective_checkpoint_contexts", recording)
    _, _, _, model = U.make_pair(seed=3, remove_timestamps_from_ctc=True)
    batch = _se_batch(np.random.default_rng(4), model.cfg)
    batch = {k: v for k, v in batch.items() if not k.startswith("enroll")}
    aten, must = torch.ops.aten, ckpt.CheckpointPolicy.MUST_SAVE
    _grads(model, batch, "dots")
    assert {aten.addmm.default, aten.mm.default, aten.bmm.default} <= set(seen)
    assert {f for f, outs in seen.items() if must in outs} == {
        aten.addmm.default, aten.mm.default}
    seen.clear()
    _grads(model, batch, "attn")
    assert not seen


def test_unknown_policy_is_refused():
    _, _, _, model = U.make_pair(seed=0)
    with pytest.raises(ValueError, match="remat_policy"):
        model.set_gradient_checkpointing(True, "everything")
    assert W.remat_context("full") is ckpt.noop_context_fn
    assert W.remat_context("attn") is ckpt.noop_context_fn
