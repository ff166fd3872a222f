"""LoRA in the port against the JAX package (tests/test_lora.py's checks,
with the JAX package as the oracle): identity at init, only the targets
change, gradients reach A with B perturbed; the loss and the adapters'
gradients of one step; the labels; a Trainer run with the JAX tree carried
across by ``lora_state_dict_from_jax``; and the merged export against
JAX's ``merge_lora``."""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity_utils as U
from test_torch_train_step import NUM_PREFIX, _batch, _jax_loss, _train_cfgs
from ts_asr_whisper_tpu.config import load_config
from ts_asr_whisper_tpu.parallel.mesh import make_mesh
from ts_asr_whisper_tpu.training import optim as JO
from ts_asr_whisper_tpu.training import trainer as JT
from ts_asr_whisper_tpu.training.lora import init_lora as jax_init_lora
from ts_asr_whisper_tpu.training.lora import merge_lora as jax_merge_lora
from ts_asr_whisper_tpu_torch.models.convert import (lora_state_dict_from_jax,
                                                     state_dict_from_jax)
from ts_asr_whisper_tpu_torch.training import lora as TL
from ts_asr_whisper_tpu_torch.training import optim as TO
from ts_asr_whisper_tpu_torch.training import trainer as TT

TARGETS = {f"model.decoder.layers.{i}.{attn}.{proj}"
           for i in range(2) for attn in ("self_attn", "encoder_attn")
           for proj in ("q_proj", "v_proj")}


def _lora_pair(seed=0, b_shift=0.0):
    """(jax cfg, params with a 'lora' tree, torch cfg, model with the same
    adapters); ``b_shift`` added to every B (a fresh B is 0)."""
    jcfg, params, tcfg, model = U.make_pair(seed=seed,
                                            remove_timestamps_from_ctc=True)
    lora = jax_init_lora(jax.random.PRNGKey(seed + 1), params)
    lora = jax.tree.map(np.asarray, lora)
    for projs in lora["decoder"]["layers"].values():
        for ab in projs.values():
            ab["lora_B"] = ab["lora_B"] + b_shift
    TL.init_lora(model, torch.Generator().manual_seed(seed))
    missing = model.load_state_dict(lora_state_dict_from_jax(lora),
                                    strict=False)
    assert not missing.unexpected_keys
    assert {k.rsplit(".", 1)[0] for k in model.state_dict()
            if "lora_" in k} == TARGETS
    return jcfg, dict(params, lora=lora), tcfg, model


def test_lora_identity_at_init():
    _, params, _, model = U.make_pair(seed=0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, 100, (2, 6)))
    enc = torch.randn(2, 8, model.cfg.d_model)
    with torch.no_grad():
        ref = model.decoder(ids, enc)
    TL.init_lora(model, torch.Generator().manual_seed(1), rank=4)
    assert {n for n, _ in TL.lora_linears(model)} == TARGETS
    for _, m in TL.lora_linears(model):
        assert m.lora_A.shape == (4, m.in_features)
        assert not m.lora_B.any() and m.lora_A.abs().max() > 0
    with torch.no_grad():
        assert torch.equal(model.decoder(ids, enc), ref)
    TL.merge_lora(model)
    after = model.state_dict()
    assert set(after) == set(before)
    for k, v in before.items():
        assert torch.equal(after[k], v), k


def test_merge_changes_targets_only_as_jax():
    """B perturbed: the merged export equals JAX's merge_lora carried
    across by the weight bridge; every other tensor is untouched."""
    jcfg, params, tcfg, model = _lora_pair(seed=0, b_shift=0.1)
    base = {k: v for k, v in params.items() if k != "lora"}
    before = state_dict_from_jax(base, tcfg)
    ref = state_dict_from_jax(jax.tree.map(np.asarray, jax_merge_lora(
        base, params["lora"])), tcfg)
    sd = TL.merge_lora(model).state_dict()
    assert set(sd) == set(ref) and not any("lora" in k for k in sd)
    for k, v in ref.items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), atol=1e-6,
                                   err_msg=k)
        changed = not np.array_equal(sd[k].numpy(), before[k].numpy())
        assert changed == (k.rsplit(".", 1)[0] in TARGETS
                           and k.endswith(".weight")), k


def test_one_step_loss_and_adapter_gradients_match_jax():
    """B perturbed so that A receives a gradient; the dense weights and the
    adapters both differentiated, as the JAX loss on the merged tree."""
    jcfg, params, tcfg, model = _lora_pair(seed=1, b_shift=0.05)
    batch = _batch(np.random.default_rng(2), jcfg)
    base_loss = _jax_loss(jcfg, batch)

    def loss(params):
        base = {k: v for k, v in params.items() if k != "lora"}
        return base_loss(jax_merge_lora(base, params["lora"]))

    (jtotal, _), jgrads = jax.value_and_grad(loss, has_aux=True)(params)
    total, _ = TT.loss_fn(model, tcfg, TT.to_device(batch, "cpu"),
                          NUM_PREFIX)
    total.backward()
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
    jg = jax.tree.map(np.asarray, jgrads)
    ref = {**state_dict_from_jax({k: v for k, v in jg.items()
                                  if k != "lora"}, tcfg),
           **lora_state_dict_from_jax(jg["lora"])}
    for name, p in model.named_parameters():
        r = ref[name].numpy()  # tolerance: test_torch_se_dicow_train.py
        np.testing.assert_allclose(
            p.grad.numpy(), r, rtol=1e-4,
            atol=max(1e-5, 2e-4 * float(np.abs(r).max())), err_msg=name)
        if "lora_" in name:
            assert p.grad.abs().max() > 0, name


def test_merged_decodes_the_merge_and_restores():
    """Inside ``merged`` the model is merge_lora's (no adapter, the merged
    weights; the decoder gives what its forward with the adapters gives);
    after it every tensor is back bit for bit, in the same parameters."""
    _, _, _, model = _lora_pair(seed=4, b_shift=0.1)
    ids = torch.from_numpy(np.random.default_rng(5).integers(
        0, 100, (2, 6)))
    enc = torch.randn(2, 8, model.cfg.d_model)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    params = dict(model.named_parameters())
    ref = TL.merge_lora(copy.deepcopy(model)).state_dict()
    with torch.no_grad():
        out = model.decoder(ids, enc)
        with TL.merged(model):
            sd = model.state_dict()
            assert set(sd) == set(ref) and not any(TL.lora_linears(model))
            for k, v in ref.items():
                assert torch.equal(sd[k], v), k
            torch.testing.assert_close(model.decoder(ids, enc), out,
                                       atol=1e-6, rtol=1e-5)
    assert dict(model.named_parameters()) == params
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_adapters_get_gradients_under_checkpointing():
    """The recompute of a checkpointed decoder layer merges the adapters
    again: the same gradients as without checkpointing."""
    jcfg, _, _, model = _lora_pair(seed=2, b_shift=0.05)
    batch = TT.to_device(_batch(np.random.default_rng(3), jcfg), "cpu")
    grads = []
    for remat in (False, True):
        model.set_gradient_checkpointing(remat, "attn")
        model.zero_grad(set_to_none=True)
        TT.loss_fn(model, model.cfg, batch, NUM_PREFIX)[0].backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for n, g in grads[0].items():
        assert torch.equal(g, grads[1][n]), n


@pytest.mark.parametrize("preheat_only", [True, False])
def test_lora_labels_match_jax(preheat_only):
    """Adapters are frozen in the preheat phase and train after it, though
    the 'decoder' keyword freezes the dense weights they wrap."""
    _, params, _, model = _lora_pair(seed=0)
    preheat = load_config([], n_devices=1).model.prefixes_to_preheat
    mask = JO.trainable_mask(params, preheat, ["decoder"], preheat_only)
    labels = TO.param_labels(model, preheat, ["decoder"], preheat_only)
    ref = {**state_dict_from_jax(
        jax.tree.map(lambda p, m: np.full(np.shape(p), m),
                     {k: v for k, v in params.items() if k != "lora"},
                     {k: v for k, v in mask.items() if k != "lora"}),
        model.cfg),
        **lora_state_dict_from_jax(jax.tree.map(
            lambda p, m: np.full(np.shape(p), m), params["lora"],
            mask["lora"]))}
    for name, label in labels.items():
        assert (label != "frozen") == bool(ref[name].flatten()[0]), name
        if "lora_" in name:
            assert label == ("frozen" if preheat_only else "base"), name


def test_trainer_with_lora_matches_jax(tmp_path):
    """The JAX Trainer and the port's from the same weights and adapters
    (B perturbed), the decoder frozen: 4 micro-batches, one preheat and one
    base update. Only the adapters and the encoder's parameters move, the
    logged gradient norms carry the JAX trainer's keys (the adapters'
    under grad_norm/lora/decoder), and the merged export equals JAX's
    merge_lora of its final tree."""
    jcfg, params, tcfg, model = _lora_pair(seed=3, b_shift=0.02)
    jc, tc = _train_cfgs(tmp_path, "training.max_steps=4",
                         "training.use_lora=true", "training.watch_grads=true")
    rng = np.random.default_rng(4)
    batches = [_batch(rng, jcfg) for _ in range(4)]
    start = {k: v.clone() for k, v in model.state_dict().items()}
    jt = JT.Trainer(jc, jcfg, jax.tree.map(jnp.asarray, params),
                    num_prefix_tokens=NUM_PREFIX, mesh=make_mesh([1]))
    jstate = jt.train(iter(batches))
    tt = TT.Trainer(tc, model, num_prefix_tokens=NUM_PREFIX)
    tt.train(iter(batches))
    jp = jax.tree.map(np.asarray, jstate.params)
    ref = {**state_dict_from_jax({k: v for k, v in jp.items()
                                  if k != "lora"}, tcfg),
           **lora_state_dict_from_jax(jp["lora"])}
    moved = set()
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                   atol=1e-6, err_msg=name)
        if not torch.equal(p.detach(), start[name]):
            moved.add(name)
    assert {n for n in moved if "lora_" in n} == {
        f"{t}.{ab}" for t in TARGETS for ab in ("lora_A", "lora_B")}
    assert not {n for n in moved if ".decoder." in n and "lora_" not in n}
    assert any(n.startswith("model.encoder.") for n in moved)
    jlog, tlog = ([json.loads(line) for line in
                   (tmp_path / side / "metrics.jsonl").read_text()
                   .splitlines()] for side in ("j", "t"))
    assert [sorted(r) for r in tlog] == [sorted(r) for r in jlog]
    assert "grad_norm/lora/decoder" in tlog[-1]
    for r, o in zip(jlog, tlog):
        np.testing.assert_allclose(o["loss"], r["loss"], rtol=1e-5)
    merged = state_dict_from_jax(jax.tree.map(np.asarray, jax_merge_lora(
        {k: v for k, v in jstate.params.items() if k != "lora"},
        jstate.params["lora"])), tcfg)
    sd = TL.merge_lora(model).state_dict()
    assert set(sd) == set(merged)
    for k, v in merged.items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), atol=1e-6,
                                   err_msg=k)
