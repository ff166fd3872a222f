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


def _random_grads(tx, rng, none_every=0):
    """One gradient per trained leaf; with ``none_every``, every such leaf
    without one (None)."""
    return [None if none_every and i % none_every == 0 else
            torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(
                np.float32) * 0.1) for i, p in enumerate(tx.params)]


@pytest.mark.parametrize("case", ["g_norm", "none_grads"])
def test_step_takes_the_callers_norm_and_none_gradients(case):
    """``step(grads, g_norm=global_norm(grads))`` equals ``step(grads)``
    (the trainer hands its norm over), and a None gradient steps as a zero
    one, bit for bit over three updates with the clip on."""
    cfg = _training_cfg(learning_rate=1e-4, warmup_steps=0, max_steps=10,
                        max_grad_norm=0.5, weight_decay=0.01)
    _, _, _, model = U.make_pair(seed=6)
    _, _, _, twin = U.make_pair(seed=6)
    a, _ = TO.build_optimizer(model, cfg, PREHEAT, FROZEN, False)
    b, _ = TO.build_optimizer(twin, cfg, PREHEAT, FROZEN, False)
    rng = np.random.default_rng(7)
    for _ in range(3):
        grads = _random_grads(a, rng, none_every=5 if case == "none_grads"
                              else 0)
        if case == "g_norm":
            a.step(grads, g_norm=TO.global_norm(grads))
            b.step(grads)
        else:
            zeros = [torch.zeros_like(p) if g is None else g
                     for g, p in zip(grads, b.params)]
            # the norm's sums run in another order with the zeros in them
            norm = TO.global_norm(zeros)
            np.testing.assert_allclose(float(TO.global_norm(grads)),
                                       float(norm), rtol=1e-6)
            a.step(grads, g_norm=norm)
            b.step(zeros, g_norm=norm)
    assert a.count == b.count == 3
    for (name, p), q in zip(model.named_parameters(), twin.parameters()):
        assert torch.equal(p, q), name


@pytest.mark.parametrize("accumulation", [1, 2])
def test_train_step_computes_the_norm_once_an_update(tmp_path, monkeypatch,
                                                     accumulation):
    """At accumulation 1 ``train_step`` computes the global norm once and
    hands it to the update; under MultiSteps each micro-batch computes the
    logged norm and the inner update that of the running mean."""
    from ts_asr_whisper_tpu_torch.config import load_config as port_config
    from ts_asr_whisper_tpu_torch.training import trainer as TT
    from ts_asr_whisper_tpu_torch.utils import observability as OBS

    _, _, _, model = U.make_pair(seed=8)
    cfg = port_config([
        "model.dtype=float32", "training.use_fddt_only_n_steps=0",
        "training.use_fddt_only_n_epochs=0", "training.max_steps=4",
        f"training.gradient_accumulation_steps={accumulation}",
        "training.warmup_steps=0", "training.eval_strategy=no",
        "training.save_strategy=no", "training.mesh_shape=[1]",
        "model.params_to_keep_frozen_keywords=[decoder]",
        f"training.output_dir={tmp_path}"], n_devices=1)
    tt = TT.Trainer(cfg, model, num_prefix_tokens=2)
    inner = getattr(tt.tx, "inner", tt.tx)
    norms, handed = [], []
    orig_norms, orig_step = OBS._norms, inner.step
    monkeypatch.setattr(OBS, "_norms", lambda *a, **k: norms.append(1)
                        or orig_norms(*a, **k))

    def step(grads, g_norm=None):
        handed.append(g_norm)
        return orig_step(grads, g_norm)

    monkeypatch.setattr(inner, "step", step)
    rng = np.random.default_rng(9)
    logged = []
    for _ in range(2 * accumulation):
        feats, stno = U.encoder_inputs(rng)
        labels = rng.integers(0, 1990, (2, 16))
        labels[:, :3] = [1994, 1995, 1996]
        batch = {"input_features": feats, "stno_mask": stno,
                 "labels": labels, "upp_labels": labels}
        logged.append(tt.train_step(TT.to_device(batch, "cpu"))["grad_norm"])
    assert inner.count == 2 and len(handed) == 2
    if accumulation == 1:
        assert len(norms) == 2
        assert all(h is n for h, n in zip(handed, logged))
    else:
        assert len(norms) == 2 * accumulation + 2
        assert handed == [None, None]


@pytest.mark.parametrize("chunk,max_leaves", [(4, 3), (16, 768), (7, 1)])
def test_multi_tensor_plan_over_ragged_leaves(chunk, max_leaves):
    """The launches of the multi-tensor kernels: every leaf in exactly one
    launch of at most ``max_leaves``, each block of a launch inside its
    leaf (an empty leaf takes none), and each slot of the norm summing the
    blocks of its own leaves."""
    from ts_asr_whisper_tpu_torch.ops import multi_tensor as MT

    rng = np.random.default_rng(chunk)
    numels = [int(n) for n in rng.choice([0, 1, 2, 3, 5, 17, 64, 65, 1000],
                                         size=40)]
    segments = MT.plan_segments(numels, chunk, max_leaves)
    assert [s.first for s in segments] == list(range(0, 40, max_leaves))
    assert segments[-1].last == 40
    owner = []  # (launch, leaf, first element) of every block
    for k, seg in enumerate(segments):
        assert 0 < seg.last - seg.first <= max_leaves
        for b in range(int(seg.chunk_end[-1])):
            i = int(np.searchsorted(seg.chunk_end, b, side="right"))
            start = (b - (int(seg.chunk_end[i - 1]) if i else 0)) * chunk
            assert start < numels[seg.first + i]
            owner.append((k, seg.first + i, start))
    assert len(owner) == sum(-(-n // chunk) for n in numels)
    assert len(set(owner)) == len(owner)
    # the norm's slots: leaves sorted by slot, slot s = blocks [e[s-1], e[s])
    slots = sorted(rng.integers(0, 6, size=40).tolist())
    ends = MT.slot_ends(slots, segments, 7)
    for s in range(7):
        lo = int(ends[s - 1]) if s else 0
        assert [leaf for _, leaf, _ in owner[lo:int(ends[s])]] == [
            i for i in range(40) if slots[i] == s
            for _ in range(-(-numels[i] // chunk))]
    assert list(MT.slot_ends([], [], 3)) == [0, 0, 0]
