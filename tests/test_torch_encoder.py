"""Port DiCoW encoder vs the JAX package's ``dicow_encoder_forward`` at fp32
on the same weights (XLA attention on the JAX side; on the CPU the port's
flash dispatch runs the kernel's plain version)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_utils import encoder_inputs, make_pair
from ts_asr_whisper_tpu.models import dicow as jd
from ts_asr_whisper_tpu.models import whisper as jw
from ts_asr_whisper_tpu_torch.ops import attention as A

# fp32 end to end; 2 layers of different summation orders stay ~1e-5
ATOL, RTOL = 1e-4, 1e-4

VARIANTS = {
    "diagonal": {},
    "full": {"fddt_is_diagonal": False, "fddt_init": "suppressive"},
    "bias_only": {"fddt_bias_only": True},
    "no_pre_pos": {"use_pre_pos_fddt": False},
    "partial_layers": {"apply_fddt_to_n_layers": 1},
    "no_fddt": {"use_fddt": False},
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_encoder_parity(rng, variant):
    jcfg, params, _, model = make_pair(**VARIANTS[variant])
    feats, stno = encoder_inputs(rng)
    ref = np.asarray(jd.dicow_encoder_forward(
        params["encoder"], jcfg, jnp.asarray(feats), jnp.asarray(stno)))
    before = A.launch_counts["flash_attn_fwd"]
    with torch.no_grad():
        out = model.encoder(torch.from_numpy(feats),
                            torch.from_numpy(stno)).numpy()
    assert out.shape == ref.shape == (2, 300, 128)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)
    # CPU tensors take the plain version: the kernel was never launched
    assert A.launch_counts["flash_attn_fwd"] == before


def test_ctc_logits_parity(rng):
    jcfg, params, _, model = make_pair()
    feats, stno = encoder_inputs(rng)
    hidden = jd.dicow_encoder_forward(params["encoder"], jcfg,
                                      jnp.asarray(feats), jnp.asarray(stno))
    ref = np.asarray(jd.encoder_ctc_logits(params["encoder"], jcfg, hidden))
    with torch.no_grad():
        out = model.encoder.ctc_logits(
            torch.from_numpy(np.array(hidden))).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


def test_decoder_forward_and_logits_parity(rng):
    jcfg, params, _, model = make_pair()
    enc = rng.standard_normal((2, 300, 128)).astype(np.float32)
    ids = rng.integers(0, 1990, size=(2, 5))
    dec = params["decoder"]
    ref = np.asarray(jw.lm_logits(dec, jw.decoder_forward(
        dec, jcfg, jnp.asarray(ids), jnp.asarray(enc))))
    with torch.no_grad():
        d = model.decoder
        out = d.lm_logits(d(torch.from_numpy(ids),
                            torch.from_numpy(enc))).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


def test_cached_decoder_matches_teacher_forced(rng):
    """Prefill + single-token steps through the cache give the JAX
    package's decoder_cached hidden states, step by step."""
    jcfg, params, _, model = make_pair()
    enc = rng.standard_normal((2, 300, 128)).astype(np.float32)
    ids = rng.integers(0, 1990, size=(2, 6))
    dec = params["decoder"]
    cross = jw.precompute_cross_kv(dec, jcfg, jnp.asarray(enc))
    cache = jw.init_kv_cache(jcfg, 2, 8)
    d = model.decoder
    t_cross = d.precompute_cross_kv(torch.from_numpy(enc))
    t_cache = d.init_kv_cache(2, 8, torch.device("cpu"))
    steps = [(0, 3), (3, 4), (4, 5), (5, 6)]
    with torch.no_grad():
        for s, e in steps:
            ref, cache = jw.decoder_cached(dec, jcfg, jnp.asarray(ids[:, s:e]),
                                           s, cache, cross)
            out = d.decoder_cached(torch.from_numpy(ids[:, s:e]), s, t_cache,
                                   t_cross)
            np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                       atol=ATOL, rtol=RTOL)
