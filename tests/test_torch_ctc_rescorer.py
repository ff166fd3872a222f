"""Joint CTC rescoring of the port (decoding/ctc_rescorer.py) against the
JAX package's ``CTCRescorer`` on numpy-seeded inputs: ``rescore`` (fused
scores at rtol/atol 2e-5) and ``update_state`` (``r_prev`` and
``score_prev`` at 1e-5), in beam mode (both psi paths) and at n=1."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity_utils  # noqa: F401  (caps torch's threads)
from ts_asr_whisper_tpu.decoding import ctc_rescorer as J
from ts_asr_whisper_tpu_torch.decoding import ctc_rescorer as T

V_DEC = 320
TS_BEGIN = V_DEC - 60
EOS, SOT = 30, 31
BLANK = V_DEC
TL = 36


def _scorers(k):
    kw = dict(blank_id=BLANK, eos_id=EOS, timestamp_begin=TS_BEGIN,
              ctc_weight=0.3, k=k, prefix_len=3)
    return J.CTCRescorer(**kw), T.CTCRescorer(**kw)


def _inputs(rng, b_audio, n, buf_len=12):
    enc_logits = (rng.standard_normal((b_audio, TL, V_DEC + 1)) * 2) \
        .astype(np.float32)
    upper_to_lower = np.stack([np.arange(100, 120), np.arange(200, 220)])
    bb = b_audio * n
    # prompt, then text with timestamps interleaved
    tokens = rng.integers(40, TS_BEGIN, size=(bb, buf_len)).astype(np.int32)
    tokens[:, 0] = SOT
    tokens[:, 3] = TS_BEGIN
    tokens[1, 5] = TS_BEGIN + 7
    scores = rng.standard_normal((bb, V_DEC)).astype(np.float32)
    scores = scores - np.log(np.exp(scores).sum(-1, keepdims=True))
    scores[-1, 50:90] = scores[-1, 49]          # exact ties at the threshold
    scores[:, TS_BEGIN + 30:] = -np.inf
    return enc_logits, upper_to_lower, tokens, scores


def _j(x):
    return jnp.asarray(x)


def _t(x):
    x = torch.from_numpy(np.asarray(x))
    return x.long() if x.dtype == torch.int32 else x


def _run_steps(rng, n, psi_impl, k, steps=3):
    """A few rescore/update steps on both sides from the same inputs."""
    js, ts = _scorers(k)
    enc, u2l, tokens, scores = _inputs(rng, 2, n)
    jst = J.init_ctc_state(_j(enc), BLANK, u2l, num_beams=n, k=k,
                           psi_impl="matmul")
    tst = T.init_ctc_state(_t(enc), BLANK, u2l, num_beams=n, k=k,
                           psi_impl=psi_impl)
    bb = tokens.shape[0]
    for step in range(steps):
        cur_len = 6 + step
        fj, jst = js.rescore(jst, _j(tokens), jnp.asarray(cur_len), _j(scores))
        ft, tst = ts.rescore(tst, _t(tokens), cur_len, _t(scores))
        np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=2e-5,
                                   atol=2e-5)
        nxt = np.asarray(jnp.argmax(fj, axis=-1)).astype(np.int32)
        nxt[0] = TS_BEGIN + 3                    # a timestamp keeps the state
        beam_idx = (np.arange(bb) // n * n
                    + rng.integers(0, n, size=bb)).astype(np.int32)
        jst = js.update_state(jst, _j(nxt), _j(beam_idx))
        tst = ts.update_state(tst, _t(nxt), _t(beam_idx))
        np.testing.assert_allclose(tst.r_prev.numpy(), np.asarray(jst.r_prev),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tst.score_prev.numpy(),
                                   np.asarray(jst.score_prev), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(tst.decoded_len.numpy(),
                                      np.asarray(jst.decoded_len))
        np.testing.assert_array_equal(tst.last_label.numpy(),
                                      np.asarray(jst.last_label))
        tokens[:, cur_len] = nxt
        scores = np.roll(scores, 7, axis=1)
    return tst


@pytest.mark.parametrize("psi_impl", ["matmul", "gather"])
def test_beam_mode_matches_jax(rng, psi_impl):
    st = _run_steps(rng, 3, psi_impl, k=40)
    assert st.cand_ids.dtype == torch.bool
    assert (st.p_vt is not None) == (psi_impl == "gather")
    assert (st.p_tv is not None) == (psi_impl == "matmul")


def test_single_hypothesis_matches_jax(rng):
    st = _run_steps(rng, 1, "auto", k=40)
    assert st.cand_ids.shape == (2, 40) and st.p_tv is None


def test_port_gather_matches_port_matmul(rng):
    """The two beam psi paths of the port give the same fused scores."""
    _, ts = _scorers(40)
    enc, u2l, tokens, scores = _inputs(rng, 2, 5)
    states = {impl: T.init_ctc_state(_t(enc), BLANK, u2l, num_beams=5,
                                     k=40, psi_impl=impl)
              for impl in ("matmul", "gather")}
    fused = {impl: ts.rescore(st, _t(tokens), 7, _t(scores))[0]
             for impl, st in states.items()}
    torch.testing.assert_close(fused["gather"], fused["matmul"], rtol=2e-5,
                               atol=2e-5)


def test_case_fold_and_bf16_posterior(rng):
    enc, u2l, _, _ = _inputs(rng, 1, 2)
    st = T.init_ctc_state(_t(enc), BLANK, u2l, num_beams=2, k=8,
                          p_bf16=True, psi_impl="gather")
    torch.testing.assert_close(st.logp_vt[:, 100:120], st.logp_vt[:, 200:220])
    assert st.p_vt.dtype == torch.bfloat16
    st = T.init_ctc_state(_t(enc), BLANK, None, num_beams=2, k=8)
    assert st.p_tv.dtype == torch.float32       # fp32 unless ctc_p_bf16


def test_resolve_psi_impl():
    assert T.resolve_psi_impl("auto", torch.device("cpu")) == "matmul"
    assert T.resolve_psi_impl("auto", torch.device("cuda")) == "gather"
    for impl in ("matmul", "gather"):
        assert T.resolve_psi_impl(impl, torch.device("cpu")) == impl
    with pytest.raises(ValueError):
        T.resolve_psi_impl("nope", torch.device("cpu"))
    assert jax.default_backend() == "cpu"
