"""Candidate-restricted CTC psi of the port (ops/psi_gather.py) against the
JAX package's ``ctc_psi_candidates`` (its DMA-gather kernel in interpret
mode), on numpy-seeded inputs. The port's plain gather + dot runs here; the
CUDA kernel is held against it on the card (test_torch_kernel_cuda.py).
Tolerances: psi values rtol/atol 2e-5 (fp32 sums in another order), the
eos column 1e-6, the sparsity pattern exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity_utils  # noqa: F401  (caps torch's threads)
from ts_asr_whisper_tpu.ops import ctc_prefix as JC
from ts_asr_whisper_tpu.ops import psi_gather as J
from ts_asr_whisper_tpu_torch.decoding.ctc_rescorer import candidate_mask
from ts_asr_whisper_tpu_torch.kernels import launch_counts
from ts_asr_whisper_tpu_torch.ops import psi_gather as T


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("bb,k_pad,popcount", [(4, 128, 37), (3, 8, 8),
                                               (2, 16, 1), (2, 512, 0)])
def test_extract_topk_ids_matches_jax(rng, bb, k_pad, popcount):
    v = 700
    mask = np.zeros((bb, v), bool)
    for b in range(bb):
        mask[b, rng.choice(v, size=popcount, replace=False)] = True
    ids_j = np.asarray(J.extract_topk_ids(jnp.asarray(mask), k_pad))
    ids_t = T.extract_topk_ids(_t(mask), k_pad)
    assert ids_t.dtype == torch.int32
    np.testing.assert_array_equal(ids_t.numpy(), ids_j)


def test_padded_posterior_layout(rng):
    p = _t(rng.random((2, 5, 375), dtype=np.float32))
    for dt in (torch.float32, torch.bfloat16):
        pp = T.padded_posterior(p, dt)
        assert pp.shape == p.shape and pp.dtype == dt
        assert pp.stride() == (5 * 376, 376, 1)
        torch.testing.assert_close(pp.float(), p.to(dt).float(), atol=0,
                                   rtol=0)


def _case(rng, b_audio=2, n=3, t=40, v_dec=300, k=20, eos=7):
    """Posterior, prefix state and a candidate mask as the rescorer builds
    them: top-k of random scores with heavy ties, plus EOS."""
    v = v_dec + 1
    logits = rng.standard_normal((b_audio, t, v)).astype(np.float32) * 2
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    bb = b_audio * n
    audio_idx = (np.arange(bb) // n).astype(np.int32)
    r, _ = JC.initial_ctc_state(jnp.asarray(logp), v_dec)
    r = np.asarray(r)[audio_idx] \
        + rng.standard_normal((bb, t, 2)).astype(np.float32) * 0.1
    dl = rng.integers(0, 4, size=bb).astype(np.int32)
    dl[0] = 0
    last = rng.integers(10, v_dec, size=bb).astype(np.int32)
    scores = rng.integers(-4, 2, size=(bb, v_dec)).astype(np.float32)
    mask = candidate_mask(_t(scores), k, eos, v_dec - 50).numpy()
    mask[1, last[1]] = True   # the last-label column is a candidate
    x_last = np.swapaxes(logp, 1, 2)[audio_idx, last]
    p_vt = np.ascontiguousarray(np.exp(np.swapaxes(logp, 1, 2)))
    return dict(p_vt=p_vt, p_tv=np.exp(logp), mask=mask, audio_idx=audio_idx,
                x_last=x_last, r=r, dl=dl, last=last, eos=eos, blank=v_dec,
                k_pad=-(-(k + 1) // 128) * 128)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_psi_matches_jax_gather_kernel(seed):
    c = _case(np.random.default_rng(seed))
    p4 = J.fold_posterior(jnp.asarray(c["p_vt"]), dtype=jnp.float32)
    ref = np.asarray(J.ctc_psi_candidates(
        p4, jnp.asarray(c["mask"]), jnp.asarray(c["audio_idx"]),
        jnp.asarray(c["x_last"]), jnp.asarray(c["r"]), jnp.asarray(c["dl"]),
        jnp.asarray(c["last"]), c["eos"], k_pad=c["k_pad"], interpret=True))
    before = launch_counts["psi_gather_dot"]
    out = T.ctc_psi_candidates(
        T.padded_posterior(_t(c["p_vt"]), torch.float32), _t(c["mask"]),
        _t(c["audio_idx"]).long(), _t(c["x_last"]), _t(c["r"]),
        _t(c["dl"]).long(), _t(c["last"]).long(), c["eos"],
        k_pad=c["k_pad"]).numpy()
    assert launch_counts["psi_gather_dot"] == before  # CPU: no launch
    live = c["mask"].copy()
    np.testing.assert_array_equal(out > JC.LOG_ZERO / 2,
                                  ref > JC.LOG_ZERO / 2)
    np.testing.assert_array_equal(out[~live], ref[~live])
    live[:, c["eos"]] = False
    np.testing.assert_allclose(out[live], ref[live], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out[:, c["eos"]], ref[:, c["eos"]],
                               rtol=1e-6, atol=1e-6)


def test_plain_psi_matches_masked_matmul(rng):
    """The contract of psi_gather.py:162-165: where(cand_mask,
    ctc_psi_matmul(...), LOG_ZERO)."""
    c = _case(rng)
    args = [_t(c[k]) for k in ("x_last", "r")]
    dl, last = _t(c["dl"]).long(), _t(c["last"]).long()
    from ts_asr_whisper_tpu_torch.ops.ctc_prefix import ctc_psi_matmul

    full = ctc_psi_matmul(_t(c["p_tv"]), *args, dl, last, c["blank"],
                          c["eos"])
    want = torch.where(_t(c["mask"]), full[:, :c["blank"]], JC.LOG_ZERO)
    out = T.ctc_psi_candidates(_t(c["p_vt"]), _t(c["mask"]),
                               _t(c["audio_idx"]).long(), *args, dl, last,
                               c["eos"], k_pad=c["k_pad"])
    torch.testing.assert_close(out, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("seed", range(4))
def test_candidate_popcount_within_k_pad(seed):
    """The mask has at most k + 1 bits (ctc_rescorer.py:250-261) even on
    tie-heavy rows, so extract_topk_ids drops no candidate."""
    r = np.random.default_rng(seed)
    k, ts_begin, v_dec, eos = 500, 1800, 2000, 1797
    scores = r.integers(-2, 1, size=(6, v_dec)).astype(np.float32)
    scores[0] = 0.0                                 # one tie over every column
    scores[1, :] = np.finfo(np.float32).min
    scores[2, eos] = 5.0                            # EOS among the top-k
    mask = candidate_mask(_t(scores), k, eos, ts_begin)
    k_pad = -(-(k + 1) // 128) * 128
    assert (mask.sum(dim=1) <= k + 1).all() and k + 1 <= k_pad
    assert mask[:, eos].all()
    assert not mask[:, ts_begin:].any()             # no timestamp column
    ids = T.extract_topk_ids(mask, k_pad)
    for b in range(scores.shape[0]):
        want = torch.nonzero(mask[b])[:, 0]
        assert torch.equal(ids[b, :len(want)].long(), want)


def test_candidate_mask_matches_jax_rescorer_rule(rng):
    """candidate_mask reproduces the membership the JAX rescorer builds
    inline (ctc_rescorer.py:243-261), ties included."""
    from jax import numpy as jnp2

    k, ts_begin, eos = 12, 150, 40
    scores = rng.integers(-3, 1, size=(5, 200)).astype(np.float32)
    scores[3, eos] = -10.0                          # EOS not in the top-k
    keys, kth = JC.kth_largest_keys(jnp2.asarray(scores[:, :ts_begin]), k)
    greater = keys > kth[:, None]
    ties = keys == kth[:, None]
    m_needed = (k - greater.sum(axis=1))[:, None]
    tie_rank = jnp2.cumsum(ties, axis=1)
    topk = greater | (ties & (tie_rank <= m_needed))
    has_eos = topk[:, eos]
    displaced = ties & (tie_rank == m_needed)
    topk = jnp2.where(has_eos[:, None], topk, topk & ~displaced)
    want = np.zeros((5, 200), bool)
    want[:, :ts_begin] = np.asarray(topk)
    want[:, eos] = True
    got = candidate_mask(_t(scores), k, eos, ts_begin).numpy()
    np.testing.assert_array_equal(got, want)
