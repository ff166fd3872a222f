"""The port's training losses against the JAX package's: timestamp-smoothed
case-invariant decoder CE, CTC label preparation, the CTC loss (values and
gradients) and the joint DiCoW loss, at the tolerances of
tests/test_losses.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity_utils as U
from ts_asr_whisper_tpu.models import losses as JL
from ts_asr_whisper_tpu.ops import ctc as JC
from ts_asr_whisper_tpu_torch.models import losses as TL
from ts_asr_whisper_tpu_torch.ops import ctc as TC

# tests/test_losses.py:46, 69: CE and CTC values
ATOL, RTOL = 1e-4, 1e-5


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _configs(**kw):
    base = {**U.TINY, **U.DICOW, **kw}
    return U.JaxConfig(**base), U.TorchConfig(**base)


def _labels(rng, cfg, b=3, t=20, prefix=3):
    """Decoder labels with a prefix, text, timestamps, EOS and -100 pad."""
    labels = rng.integers(10, cfg.timestamp_begin, (b, t))
    labels[:, :prefix] = [cfg.decoder_start_token_id - 3,
                          cfg.decoder_start_token_id - 2,
                          cfg.decoder_start_token_id - 1]
    ts = rng.random((b, t)) < 0.3
    labels[ts] = cfg.timestamp_begin + rng.integers(0, 1501, ts.sum())
    labels[0, 12] = cfg.eos_token_id
    labels[1, 15:] = -100
    labels[2, 8:] = -100
    return labels


def test_timestamp_smoothing_matrix_is_the_same():
    np.testing.assert_array_equal(TL.timestamp_smoothing_matrix(),
                                  JL.timestamp_smoothing_matrix())


@pytest.mark.parametrize("smoothing", [True, False])
@pytest.mark.parametrize("with_upper", [True, False])
def test_decoder_ce_loss_matches(smoothing, with_upper):
    jcfg, tcfg = _configs()
    rng = np.random.default_rng(int(smoothing) * 2 + int(with_upper))
    labels = _labels(rng, jcfg)
    upp = labels.copy()
    text = (labels > 20) & (labels < jcfg.timestamp_begin)
    upp[text & (labels % 3 == 0)] += 1  # some tokens have a cased twin
    logits = rng.standard_normal((3, 20, jcfg.vocab_size)).astype(np.float32)
    ref = JL.decoder_ce_loss(jnp.asarray(logits), jnp.asarray(labels),
                             jnp.asarray(upp) if with_upper else None, jcfg,
                             use_timestamp_smoothing=smoothing)
    out = TL.decoder_ce_loss(_t(logits), _t(labels),
                             _t(upp) if with_upper else None, tcfg,
                             use_timestamp_smoothing=smoothing)
    np.testing.assert_allclose(float(out), float(ref), atol=ATOL, rtol=RTOL)
    # the gradient w.r.t. the logits, too
    jg = jax.grad(lambda x: JL.decoder_ce_loss(
        x, jnp.asarray(labels), jnp.asarray(upp) if with_upper else None,
        jcfg, use_timestamp_smoothing=smoothing))(jnp.asarray(logits))
    x = _t(logits).requires_grad_()
    TL.decoder_ce_loss(x, _t(labels), _t(upp) if with_upper else None, tcfg,
                       use_timestamp_smoothing=smoothing).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), atol=1e-6,
                               rtol=1e-5)


@pytest.mark.parametrize("remove_ts", [True, False])
@pytest.mark.parametrize("prefix", [0, 3])
def test_prepare_ctc_labels_is_the_same(remove_ts, prefix):
    jcfg, tcfg = _configs(remove_timestamps_from_ctc=remove_ts)
    labels = _labels(np.random.default_rng(prefix), jcfg, t=30)
    ref = np.asarray(JL.prepare_ctc_labels(jnp.asarray(labels), jcfg, prefix))
    out = TL.prepare_ctc_labels(_t(labels), tcfg, prefix).numpy()
    np.testing.assert_array_equal(out, ref)


def _ctc_case(seed):
    rng = np.random.default_rng(seed)
    b, t, v = 4, 24, 12
    logits = rng.standard_normal((b, t, v)).astype(np.float32) * 3
    labels = np.full((b, 16), -100, np.int64)
    labels[0, :6] = rng.integers(0, v - 1, 6)
    labels[1, :16] = rng.integers(0, v - 1, 16)
    labels[2, :13] = [1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7]  # 19 frames
    # row 3: no label at all
    return logits, labels, v - 1


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_ctc_loss_matches(reduction):
    logits, labels, blank = _ctc_case(0)
    lengths = np.array([24, 20, 14, 10])  # row 2 is infeasible

    def jf(x):
        return JC.ctc_loss(x, jnp.asarray(labels), jnp.asarray(lengths),
                           jnp.asarray((labels >= 0).sum(-1)), blank,
                           reduction=reduction)

    ref = jf(jnp.asarray(logits))
    x = _t(logits).requires_grad_()
    out = TC.ctc_loss(x, _t(labels), _t(lengths), _t((labels >= 0).sum(-1)),
                      blank, reduction=reduction)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=ATOL, rtol=RTOL)
    # zero_infinity: the infeasible row costs 0
    assert float(TC.ctc_loss(_t(logits), _t(labels), _t(lengths),
                             _t((labels >= 0).sum(-1)), blank,
                             reduction="none")[2]) == 0.0
    jg = jax.grad(lambda y: jf(y).sum())(jnp.asarray(logits))
    out.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), atol=1e-5,
                               rtol=1e-5)


def test_ctc_loss_from_padded_labels_matches():
    logits, labels, blank = _ctc_case(1)
    ref = JC.ctc_loss_from_padded_labels(jnp.asarray(logits),
                                         jnp.asarray(labels), blank)
    out = TC.ctc_loss_from_padded_labels(_t(logits), _t(labels), blank)
    np.testing.assert_allclose(float(out), float(ref), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("ctc_weight", [0.0, 0.3])
def test_dicow_loss_matches(ctc_weight):
    jcfg, tcfg = _configs(ctc_weight=ctc_weight,
                          remove_timestamps_from_ctc=True)
    rng = np.random.default_rng(7)
    labels = _labels(rng, jcfg)
    upp = labels.copy()
    logits = rng.standard_normal((3, 20, jcfg.vocab_size)).astype(np.float32)
    enc = rng.standard_normal((3, 75, jcfg.ctc_vocab_size)).astype(np.float32)
    ref_total, ref_parts = JL.dicow_loss(
        jnp.asarray(logits), jnp.asarray(enc), jnp.asarray(labels),
        jnp.asarray(upp), jcfg, num_prefix_tokens=3)
    total, parts = TL.dicow_loss(_t(logits), _t(enc), _t(labels), _t(upp),
                                 tcfg, num_prefix_tokens=3)
    assert sorted(parts) == sorted(ref_parts)
    for k in parts:
        np.testing.assert_allclose(float(parts[k]), float(ref_parts[k]),
                                   atol=ATOL, rtol=RTOL, err_msg=k)
    np.testing.assert_allclose(float(total), float(ref_total), atol=ATOL,
                               rtol=RTOL)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
