"""int8 cross-KV of the port (``gen_cfg.cross_kv_quant``) against the JAX
package's on the same weights: ``quantize_cross_kv`` (codes equal, scales at
rtol 1e-6), ``decoder_cached`` over the int8 cache (hidden at atol 1e-5,
also with n beams folded into the query axis), the int8 step within
tests/test_kv_quant.py's bound of the exact one, and greedy and beam decode
with int8 token-exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_utils import make_pair
from ts_asr_whisper_tpu.decoding.beam import beam_search as jax_beam
from ts_asr_whisper_tpu.decoding.generation_config import GenerationConfig
from ts_asr_whisper_tpu.decoding.greedy import greedy_decode as jax_greedy
from ts_asr_whisper_tpu.models import whisper as jw
from ts_asr_whisper_tpu_torch.decoding.beam import beam_search
from ts_asr_whisper_tpu_torch.decoding.greedy import greedy_decode
from ts_asr_whisper_tpu_torch.models.whisper import quantize_cross_kv
from ts_asr_whisper_tpu_torch.ops import reorder as R

MAX_NEW = 12


def _gen_cfg(cfg, **kw):
    base = dict(max_length=3 + MAX_NEW,
                decoder_start_token_id=cfg.decoder_start_token_id,
                eos_token_id=cfg.eos_token_id, pad_token_id=cfg.pad_token_id,
                bos_token_id=cfg.bos_token_id,
                no_timestamps_token_id=cfg.no_timestamps_token_id,
                return_timestamps=True, length_penalty=0.1,
                cross_kv_quant=True)
    base.update(kw)
    return GenerationConfig(**base)


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


@pytest.fixture(scope="module")
def setup():
    jcfg, params, _, model = make_pair(seed=6)
    rng = np.random.default_rng(11)
    enc = (rng.standard_normal((2, 300, 128)) * 2.0).astype(np.float32)
    prompt = np.tile(np.array([[jcfg.decoder_start_token_id, 1000, 1003]]),
                     (2, 1))
    return jcfg, params, model, enc, prompt


def _cross(jcfg, params, model, enc):
    jcross = jw.precompute_cross_kv(params["decoder"], jcfg, jnp.asarray(enc))
    tcross = model.decoder.precompute_cross_kv(torch.from_numpy(enc))
    return jcross, tcross


def test_quantize_cross_kv_matches_jax(setup):
    jcfg, params, model, enc, _ = setup
    jcross, tcross = _cross(jcfg, params, model, enc)
    jq = jw.quantize_cross_kv(jcross)
    tq = quantize_cross_kv(tcross)
    assert len(tq) == jcfg.decoder_layers
    for li, layer in enumerate(tq):
        for key in ("k_q", "v_q"):
            assert layer[key].dtype == torch.int8
            np.testing.assert_array_equal(layer[key].numpy(),
                                          np.asarray(jq[key][li]))
        for key in ("k_scale", "v_scale"):
            np.testing.assert_allclose(layer[key].numpy(),
                                       np.asarray(jq[key][li]), rtol=1e-6)
    # every code in range, and the per-row maximum reaches 127
    k_q = tq[0]["k_q"].int()
    assert k_q.abs().max() <= 127
    assert (k_q.abs().amax(dim=-1) == 127).all()


def test_quantize_rounds_half_to_even():
    """Codes round half to even, as jnp.round: rows whose max is 127 put
    the other entries exactly on .5 steps."""
    x = torch.tensor([[[[127.0, 0.5, 1.5, 2.5, -0.5, -1.5]]]])
    layer = quantize_cross_kv([(x, x)])[0]
    assert layer["k_q"][0, 0, 0].tolist() == [127, 0, 2, 2, 0, -2]
    jq = jw.quantize_cross_kv((jnp.asarray(x.numpy())[None],) * 2)
    np.testing.assert_array_equal(layer["k_q"].numpy(),
                                  np.asarray(jq["k_q"][0]))


@pytest.mark.parametrize("n", [1, 3])
def test_decoder_cached_int8_matches_jax(setup, n):
    """Prefill then one step on the int8 cache; with n > 1 the q batch is n
    times the cache batch (the beam fold)."""
    jcfg, params, model, enc, prompt = setup
    jcross, tcross = _cross(jcfg, params, model, enc)
    jq, tq = jw.quantize_cross_kv(jcross), quantize_cross_kv(tcross)
    ids = np.repeat(prompt, n, axis=0)
    bb = ids.shape[0]
    dec = model.decoder
    jcache = jw.init_kv_cache(jcfg, bb, 8)
    tcache = dec.init_kv_cache(bb, 8, torch.device("cpu"))
    jh, jcache = jw.decoder_cached(params["decoder"], jcfg, jnp.asarray(ids),
                                   0, jcache, jq)
    th = dec.decoder_cached(torch.from_numpy(ids), 0, tcache, tq)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5)
    step = np.arange(bb)[:, None] + 40
    jh, _ = jw.decoder_cached(params["decoder"], jcfg, jnp.asarray(step), 3,
                              jcache, jq)
    th = dec.decoder_cached(torch.from_numpy(step), 3, tcache, tq)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5)


def test_int8_step_close_to_exact(setup):
    """tests/test_kv_quant.py's bound: max |dh| < 0.05 std(h_exact)."""
    _, _, model, enc, prompt = setup
    dec = model.decoder
    cross = dec.precompute_cross_kv(torch.from_numpy(enc))
    ids = torch.from_numpy(prompt)
    h_exact = dec.decoder_cached(ids, 0, dec.init_kv_cache(2, 8, "cpu"),
                                 cross)
    h_quant = dec.decoder_cached(ids, 0, dec.init_kv_cache(2, 8, "cpu"),
                                 quantize_cross_kv(cross))
    err = (h_exact - h_quant).abs().max().item()
    assert 0 < err < 0.05 * h_exact.std().item()


def test_greedy_int8_matches_jax(setup):
    jcfg, params, model, enc, prompt = setup
    gen_cfg = _gen_cfg(jcfg)
    ref = jax_greedy(params, jcfg, gen_cfg, jnp.asarray(enc),
                     jnp.asarray(prompt), MAX_NEW)
    out = greedy_decode(model, gen_cfg, torch.from_numpy(enc),
                        torch.from_numpy(prompt), MAX_NEW)
    np.testing.assert_array_equal(out.sequences.numpy(),
                                  np.asarray(ref.sequences))
    np.testing.assert_array_equal(out.lengths.numpy(),
                                  np.asarray(ref.lengths))
    np.testing.assert_allclose(out.sum_logprobs.numpy(),
                               np.asarray(ref.sum_logprobs), atol=1e-4)
    assert (out.sequences[:, 3:] < gen_cfg.timestamp_begin).any()


@pytest.mark.parametrize("impl", ["auto", "ancestry", "fused"])
def test_beam_int8_matches_jax(setup, impl):
    """Beam 5 over the int8 cache on the standalone permute ('auto' on the
    CPU), the ancestry cache and the fused reorder: the cross-attention of
    every step folds the 5 beams into the query axis."""
    jcfg, params, model, enc, prompt = setup
    gen_cfg = _gen_cfg(jcfg)
    ref = jax_beam(params, jcfg, gen_cfg, jnp.asarray(enc),
                   jnp.asarray(prompt), MAX_NEW, num_beams=5)
    prev = R.get_reorder_impl(raw=True)
    R.set_reorder_impl(impl)
    try:
        out = beam_search(model, gen_cfg, torch.from_numpy(enc),
                          torch.from_numpy(prompt), MAX_NEW, 5)
    finally:
        R.set_reorder_impl(prev)
    np.testing.assert_array_equal(out.sequences.numpy(),
                                  np.asarray(ref.sequences))
    np.testing.assert_array_equal(out.lengths.numpy(),
                                  np.asarray(ref.lengths))
    np.testing.assert_allclose(out.scores.numpy(), np.asarray(ref.scores),
                               rtol=2e-5, atol=2e-5)
