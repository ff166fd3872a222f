"""SE-DiCoW in the port against the JAX package on the same weights: the SCB
against ``scb_forward``, the encoder's enrollment stream against
``dicow_encoder_forward`` (fp32, the tolerance of test_torch_encoder.py),
the SCB init's structure, the weight bridge's ``ca_enrolls`` names, and
long-form greedy and beam joint-CTC decode with enrollments, tokens exact
against the JAX ``longform_generate`` (the cases of
tests/test_longform_full_parity.py:597-662 with the JAX package as the
oracle)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_longform import UPPER_TO_LOWER, _batch, _gen_cfg
from torch_parity_utils import TINY, encoder_inputs, make_pair
from ts_asr_whisper_tpu.decoding import longform as jlf
from ts_asr_whisper_tpu.models import dicow as jd
from ts_asr_whisper_tpu.models.convert import params_to_hf
from ts_asr_whisper_tpu_torch.decoding import longform as tlf
from ts_asr_whisper_tpu_torch.models.config import DiCoWConfig
from ts_asr_whisper_tpu_torch.models.convert import state_dict_from_jax
from ts_asr_whisper_tpu_torch.models.dicow import SCB, build_dicow
from ts_asr_whisper_tpu_torch.ops import attention as A

ATOL, RTOL = 1e-4, 1e-4  # as test_torch_encoder.py: fp32, 2 layers


def _se_pair(scb_layers, seed=0, gates=(0.7, -0.4)):
    """SE-DiCoW pair whose SCB gates are open (a fresh SCB's gate is 0, so
    the enrollment stream would not reach the sample stream)."""
    jcfg, params, tcfg, model = make_pair(seed=seed, use_enrollments=True,
                                          scb_layers=scb_layers)
    ca = params["encoder"]["ca_enrolls"]
    ca["gate"] = jnp.asarray(np.array(gates[:scb_layers],
                                      np.float32)[:, None])
    model.load_state_dict(state_dict_from_jax(
        jax.tree.map(np.asarray, params), tcfg), strict=True)
    return jcfg, params, tcfg, model


def _enroll(rng, b, t_enc=300, n_mels=80):
    return encoder_inputs(rng, b=b, t_enc=t_enc, n_mels=n_mels)


def test_scb_matches_scb_forward(rng):
    jcfg, params, _, model = _se_pair(2)
    x = (rng.standard_normal((2, 2, 300, 128)) * 0.5).astype(np.float32)
    for i in range(2):
        p = jax.tree.map(lambda a: a[i], params["encoder"]["ca_enrolls"])
        ref = np.asarray(jd.scb_forward(p, jnp.asarray(x), jcfg))
        with torch.no_grad():
            out = model.encoder.ca_enrolls[i](
                torch.from_numpy(x), torch.float32, flash=True).numpy()
        np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)
        # only the sample stream changes
        np.testing.assert_array_equal(out[:, 1], x[:, 1])
        assert np.abs(out[:, 0] - x[:, 0]).max() > 1e-3


@pytest.mark.parametrize("scb_layers", [1, 2])
def test_encoder_streams_match_jax(rng, scb_layers):
    jcfg, params, _, model = _se_pair(scb_layers)
    feats, stno = encoder_inputs(rng)
    e_feats, e_stno = _enroll(rng, 2)
    ref = np.asarray(jd.dicow_encoder_forward(
        params["encoder"], jcfg, jnp.asarray(feats), jnp.asarray(stno),
        jnp.asarray(e_feats), jnp.asarray(e_stno)))
    before = A.launch_counts["flash_attn_fwd"]
    with torch.no_grad():
        out = model.encoder(*(torch.from_numpy(x) for x in
                              (feats, stno, e_feats, e_stno))).numpy()
        alone = model.encoder(torch.from_numpy(feats),
                              torch.from_numpy(stno)).numpy()
    assert out.shape == ref.shape == (2, 300, 128)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)
    assert A.launch_counts["flash_attn_fwd"] == before
    # the enrollment reaches the output through the open gates
    assert np.abs(out - alone).max() > 1e-3


def test_encoder_refuses_enrollments_without_scbs(rng):
    _, _, _, model = make_pair(use_enrollments=True, scb_layers=0)
    feats, stno = (torch.from_numpy(x) for x in encoder_inputs(rng))
    with pytest.raises(ValueError, match="scb_layers"):
        model.encoder(feats, stno, feats, stno)


def test_scb_init_structure(rng):
    """init_scb (dicow.py:72-92): identity blocks on xavier(0.1) noise, zero
    biases, a zero gate; so a fresh SE-DiCoW encoder gives the sample
    stream's output whatever the enrollment."""
    cfg = DiCoWConfig(**TINY, dtype="float32", use_fddt=True,
                      use_enrollments=True, scb_layers=2)
    model = build_dicow(cfg, torch.device("cpu"), seed=1, flash=True)
    d, ffn = cfg.d_model, cfg.encoder_ffn_dim
    assert len(model.encoder.ca_enrolls) == 2
    for scb in model.encoder.ca_enrolls:
        assert isinstance(scb, SCB)
        p = scb.cae
        w0, w3 = p.ffn["0"].weight, p.ffn["3"].weight
        assert w0.shape == (ffn, 2 * d) and w3.shape == (d, ffn)
        eye = torch.eye(d)
        bound0 = 0.1 * (6.0 / (2 * d + ffn)) ** 0.5
        bound3 = 0.1 * (6.0 / (ffn + d)) ** 0.5
        noise0, noise3 = w0.clone(), w3.clone()
        noise0[:d, :d] -= eye
        noise3[:, :d] -= eye
        assert noise0.abs().max() <= bound0 and noise3.abs().max() <= bound3
        assert noise0.std() > bound0 / 4 and noise3.std() > bound3 / 4
        assert not p.ffn["0"].bias.any() and not p.ffn["3"].bias.any()
        assert p.cross_gate.gate.shape == (1,) and not p.cross_gate.gate.any()
    feats, stno = (torch.from_numpy(x) for x in encoder_inputs(rng))
    e_feats, e_stno = (torch.from_numpy(x) for x in _enroll(rng, 2))
    with torch.no_grad():
        torch.testing.assert_close(model.encoder(feats, stno, e_feats, e_stno),
                                   model.encoder(feats, stno),
                                   atol=1e-6, rtol=1e-6)


def test_scb_weights_round_trip_with_hf_names():
    jcfg, params, tcfg, model = _se_pair(2)
    hf = params_to_hf(jax.tree.map(np.asarray, params), jcfg)
    sd = state_dict_from_jax(jax.tree.map(np.asarray, params), tcfg)
    assert set(sd) == set(hf) == set(model.state_dict())
    scb_keys = sorted(k for k in sd if ".ca_enrolls." in k)
    for i in range(2):
        pre = f"model.encoder.ca_enrolls.{i}.cae"
        for name in ("cross_attn.q_proj.weight", "cross_attn.k_proj.weight",
                     "cross_attn.out_proj.bias", "ffn.0.weight", "ffn.0.bias",
                     "ffn.3.weight", "ffn.3.bias", "cross_gate.gate"):
            assert f"{pre}.{name}" in scb_keys
    assert len(scb_keys) == 2 * 12
    for k in scb_keys:
        np.testing.assert_array_equal(sd[k].numpy(), hf[k], err_msg=k)
        np.testing.assert_array_equal(model.state_dict()[k].numpy(), hf[k],
                                      err_msg=k)


LONGFORM_CASES = {
    # two rows of two windows, two SCBs (longform_full_parity.py:597-627)
    "greedy": (2, 2, (1200, 1100), {}),
    # ragged rows: the per-bucket enrollment gather (:630-662)
    "greedy_ragged": (1, 3, (1700, 600, 1240), {}),
    # se_dicow_beam_joint's decode settings
    "beam_joint_ctc": (2, 3, (1700, 1000, 350),
                       {"num_beams": 5, "ctc_weight": 0.2,
                        "length_penalty": 0.1}),
}


@pytest.mark.parametrize("case", sorted(LONGFORM_CASES))
def test_longform_with_enrollments_matches_jax(rng, case):
    scb_layers, rows, valid, overrides = LONGFORM_CASES[case]
    jcfg, params, _, model = _se_pair(scb_layers, seed=4)
    gen_cfg = _gen_cfg(jcfg, **overrides)
    feats, stno, att = (x[:rows] for x in
                        _batch(rng, valid=valid + (0,) * (3 - rows)))
    e_feats, e_stno = _enroll(np.random.default_rng(23), rows)
    forced = np.tile(np.array([[jcfg.decoder_start_token_id, 1000, 1003]]),
                     (rows, 1))
    ref = jlf.longform_generate(params, jcfg, gen_cfg, feats, stno, att,
                                forced, enroll_features=e_feats,
                                enroll_stno=e_stno, return_segments=True,
                                upper_to_lower=UPPER_TO_LOWER)
    out = tlf.longform_generate(model, gen_cfg, feats, stno, att, forced,
                                enroll_features=e_feats, enroll_stno=e_stno,
                                return_segments=True,
                                upper_to_lower=UPPER_TO_LOWER)
    np.testing.assert_array_equal(out.sequences, ref.sequences)
    assert out.windows_decoded == ref.windows_decoded >= rows
    assert [[(s.start, s.end, s.tokens.tolist()) for s in segs]
            for segs in out.segments] == \
        [[(s.start, s.end, s.tokens.tolist()) for s in segs]
         for segs in ref.segments]


def test_teacher_forced_forward_takes_enrollments(rng):
    """``DiCoW.forward`` hands the enrollments to the encoder, as
    ``dicow_forward`` does (dicow.py:220-238)."""
    jcfg, params, _, model = _se_pair(1)
    feats, stno = encoder_inputs(rng)
    e_feats, e_stno = _enroll(rng, 2)
    ids = rng.integers(0, 1990, size=(2, 7))
    ref_logits, ref_enc = jd.dicow_forward(
        params, jcfg, jnp.asarray(feats), jnp.asarray(stno), jnp.asarray(ids),
        jnp.asarray(e_feats), jnp.asarray(e_stno))
    with torch.no_grad():
        logits, enc = model(*(torch.from_numpy(x) for x in
                              (feats, stno, ids, e_feats, e_stno)))
    np.testing.assert_allclose(enc.numpy(), np.asarray(ref_enc),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               atol=ATOL, rtol=RTOL)
