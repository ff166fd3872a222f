"""CTC prefix scoring of the port (ops/ctc_prefix.py) against the JAX
package's, on numpy-seeded inputs. Tolerance 1e-5: the alpha recursion is a
log-depth scan in both, but the combine order differs; ``kth_largest_keys``
and the top-k tie rule are exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity_utils  # noqa: F401  (caps torch's threads)
from ts_asr_whisper_tpu.ops import ctc_prefix as J
from ts_asr_whisper_tpu_torch.ops import ctc_prefix as T
from ts_asr_whisper_tpu_torch.ops.topk import topk_large

TOL = 1e-5
V, TL, BLANK, EOS = 60, 37, 60, 5   # ctc vocab V + 1, blank last


def _logp(rng, b):
    x = rng.standard_normal((b, TL, V + 1)).astype(np.float32) * 2
    return x - np.log(np.exp(x).sum(-1, keepdims=True))


def _prefix(rng, bb, logp, b_audio):
    """A state a few tokens in, built by the JAX package itself."""
    r, _ = J.initial_ctc_state(jnp.asarray(logp), BLANK)
    audio_idx = np.arange(bb) // (bb // b_audio)
    r = np.asarray(r)[audio_idx]
    decoded_len = rng.integers(0, 4, size=bb).astype(np.int32)
    decoded_len[0] = 0
    last = rng.integers(6, V, size=bb).astype(np.int32)
    last[decoded_len == 0] = BLANK
    # perturb the state so that every branch sees non-trivial values
    r = r + rng.standard_normal(r.shape).astype(np.float32) * 0.1
    return audio_idx.astype(np.int32), r.astype(np.float32), decoded_len, last


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_initial_ctc_state(rng):
    logp = _logp(rng, 2)
    rj, sj = J.initial_ctc_state(jnp.asarray(logp), BLANK)
    rt, st = T.initial_ctc_state(_t(logp), BLANK)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("with_states", [True, False])
def test_ctc_prefix_scores(rng, with_states):
    b_audio, bb, k = 2, 6, 9
    logp = _logp(rng, b_audio)
    logp_vt = np.ascontiguousarray(np.swapaxes(logp, 1, 2))
    audio_idx, r, dl, last = _prefix(rng, bb, logp, b_audio)
    cand = np.stack([rng.choice(V, size=k, replace=False)
                     for _ in range(bb)]).astype(np.int32)
    cand[:, 0] = EOS
    cand[1, 1] = last[1]    # the last-label branch
    args = (audio_idx, cand, r, dl, last)
    pj, sj = J.ctc_prefix_scores(jnp.asarray(logp_vt),
                                 *(jnp.asarray(x) for x in args), BLANK, EOS,
                                 with_states=with_states)
    pt, st = T.ctc_prefix_scores(_t(logp_vt), *(_t(x).long() if x.dtype !=
                                                 np.float32 else _t(x)
                                                 for x in args),
                                 BLANK, EOS, with_states=with_states)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=TOL,
                               rtol=TOL)
    if with_states:
        assert st.shape == (bb, k, TL, 2)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=TOL,
                                   rtol=TOL)
    else:
        assert st is None and sj is None


def test_ctc_psi_matmul(rng):
    b_audio, bb = 2, 6
    logp = _logp(rng, b_audio)
    audio_idx, r, dl, last = _prefix(rng, bb, logp, b_audio)
    x_last = np.swapaxes(logp, 1, 2)[audio_idx, last]
    p_tv = np.exp(logp)
    pj = J.ctc_psi_matmul(jnp.asarray(p_tv), jnp.asarray(x_last),
                          jnp.asarray(r), jnp.asarray(dl), jnp.asarray(last),
                          BLANK, EOS)
    pt = T.ctc_psi_matmul(_t(p_tv), _t(x_last), _t(r), _t(dl).long(),
                          _t(last).long(), BLANK, EOS)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("seed", range(5))
def test_kth_largest_keys_exact_on_ties(seed):
    """As tests/test_ctc_beam_path.py:41-57: exact ties and the
    finfo(float32).min masses a processor chain leaves."""
    r = np.random.default_rng(seed)
    x = (r.standard_normal((4, 337)) * 10).astype(np.float32)
    x[:, 50:70] = np.finfo(np.float32).min
    x[1, 3] = x[1, 4] = x[1, 5]
    x[2, 100:200] = 1.5
    x[3, ::3] = -0.0
    x[3, 1::3] = 0.0
    for k in (1, 7, 64, 300, 337):
        kj, thj = J.kth_largest_keys(jnp.asarray(x), k)
        kt, tht = T.kth_largest_keys(_t(x), k)
        member_j = np.asarray(kj) >= np.asarray(thj)[:, None]
        member_t = (kt >= tht[:, None]).numpy()
        np.testing.assert_array_equal(member_t, member_j)
        # the same order: keys equal up to the uint32 encoding
        np.testing.assert_array_equal(kt.numpy(),
                                      np.asarray(kj).astype(np.int64))


def test_topk_large_tie_rule(rng):
    """lax.top_k returns equal values lower index first."""
    import jax

    x = rng.integers(-3, 3, size=(3, 500)).astype(np.float32)
    x[0] = -1e9
    x[1, 10:] = -1e9
    for k in (1, 10, 50):
        vj, ij = jax.lax.top_k(jnp.asarray(x), k)
        vt, it = topk_large(_t(x), k)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
