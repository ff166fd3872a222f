"""The port's top-k impls against ``jax.lax.top_k`` bit for bit, ties
included: the cases of tests/test_topk.py (random rows, tie-heavy rows,
all-equal rows with negative fill, k = width, the beam shape) for the
stable sort ('lax') and ``topk_thresholded``; and beam search under the
'thresholded' switch token-exact against the JAX package's beam search."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_utils import make_pair
from ts_asr_whisper_tpu.decoding.beam import beam_search as jax_beam
from ts_asr_whisper_tpu.decoding.generation_config import GenerationConfig
from ts_asr_whisper_tpu_torch.decoding import beam as B
from ts_asr_whisper_tpu_torch.ops import topk as T

IMPLS = {"lax": T.topk_lax, "thresholded": T.topk_thresholded}


def _random(rng):
    return rng.standard_normal((8, 4096)).astype(np.float32), 10


def _tie_heavy(rng):
    # few distinct values: many ties at the threshold
    return rng.choice(np.float32([-1e9, -2.0, 0.0, 0.5, 3.0]),
                      (16, 2048)).astype(np.float32), 12


def _all_equal_neg_fill(rng):
    x = np.full((4, 512), -1e9, np.float32)
    x[1, 37] = 1.0
    x[2, [5, 9]] = [2.0, 2.0]
    return x, 8


def _k_equals_width(rng):
    return rng.standard_normal((3, 16)).astype(np.float32), 16


def _beam_shape(rng):
    x = rng.standard_normal((8, 51866 * 5)).astype(np.float32)
    # exact duplicates across beam copies
    x[:, 51866:] = np.tile(x[:, :51866], (1, 4))
    return x, 10


CASES = {f.__name__[1:]: f for f in (_random, _tie_heavy, _all_equal_neg_fill,
                                      _k_equals_width, _beam_shape)}


@pytest.mark.parametrize("impl", sorted(IMPLS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_topk_matches_lax_top_k(case, impl):
    x, k = CASES[case](np.random.default_rng(sorted(CASES).index(case)))
    v_ref, i_ref = jax.lax.top_k(jnp.asarray(x), k)
    v, i = IMPLS[impl](torch.from_numpy(x), k)
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))


def test_topk_switch():
    assert T.get_topk_impl() == "lax"
    x = torch.from_numpy(_tie_heavy(np.random.default_rng(0))[0])
    try:
        T.set_topk_impl("thresholded")
        assert T.get_topk_impl() == "thresholded"
        v, i = T.topk_large(x, 12)
    finally:
        T.set_topk_impl("lax")
    v_ref, i_ref = T.topk_lax(x, 12)
    assert torch.equal(v, v_ref) and torch.equal(i, i_ref)
    with pytest.raises(ValueError):
        T.set_topk_impl("sort")


def test_beam_search_under_thresholded_matches_jax(rng, monkeypatch):
    """Beam 5 with the candidate top-k thresholded: the same tokens as the
    JAX package's beam search (lax.top_k), and the switch reached every
    step's candidate top-k."""
    jcfg, params, _, model = make_pair(seed=3)
    gen_cfg = GenerationConfig(
        max_length=15, decoder_start_token_id=jcfg.decoder_start_token_id,
        eos_token_id=jcfg.eos_token_id, pad_token_id=jcfg.pad_token_id,
        bos_token_id=jcfg.bos_token_id,
        no_timestamps_token_id=jcfg.no_timestamps_token_id,
        return_timestamps=True, length_penalty=0.1)
    enc = (rng.standard_normal((2, 300, 128)) * 2.0).astype(np.float32)
    prompt = np.tile(np.array([[jcfg.decoder_start_token_id, 1000, 1003]]),
                     (2, 1))
    ref = jax_beam(params, jcfg, gen_cfg, jnp.asarray(enc),
                   jnp.asarray(prompt), 12, num_beams=5)
    calls = []
    thresholded = T.topk_thresholded

    def counted(x, k):
        calls.append(x.shape)
        return thresholded(x, k)

    monkeypatch.setattr(T, "topk_thresholded", counted)
    T.set_topk_impl("thresholded")
    try:
        steps0 = B.counters["beam_steps"]
        with torch.no_grad():
            out = B.beam_search(model, gen_cfg, torch.from_numpy(enc),
                                torch.from_numpy(prompt), 12, 5)
        steps = B.counters["beam_steps"] - steps0
    finally:
        T.set_topk_impl("lax")
    np.testing.assert_array_equal(out.sequences.numpy(),
                                  np.asarray(ref.sequences))
    np.testing.assert_array_equal(out.lengths.numpy(),
                                  np.asarray(ref.lengths))
    assert calls == [(2, 5 * jcfg.vocab_size)] * steps and steps > 0
