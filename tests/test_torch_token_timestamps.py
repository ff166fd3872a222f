"""Token timestamps of the port against the JAX package's on the same
weights: the alignment heads' cross-attention probabilities of
``decoder_cached`` (atol 1e-6), the greedy loop's collected buffer, and
``longform_generate`` with ``return_token_timestamps``: the same tokens and
the same per-token times, frame for frame, with and without the DTW crop;
beam search with token timestamps, a config without alignment heads and the
int8 cache raise as the JAX package does."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_utils import make_pair
from ts_asr_whisper_tpu.decoding import longform as jlf
from ts_asr_whisper_tpu.decoding.generation_config import GenerationConfig
from ts_asr_whisper_tpu.decoding.greedy import greedy_decode as jax_greedy
from ts_asr_whisper_tpu.models import whisper as jw
from ts_asr_whisper_tpu_torch.decoding import longform as tlf
from ts_asr_whisper_tpu_torch.decoding.greedy import greedy_decode
from ts_asr_whisper_tpu_torch.decoding.token_timestamps import (
    alignment_slots_from_heads,
)

# (layer, head) pairs of the tiny model's 2 x 2 decoder heads
HEADS = ((0, 1), (1, 0), (1, 1))


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


@pytest.fixture(scope="module")
def pair():
    return make_pair(seed=8)


def _gen_cfg(cfg, **kw):
    base = dict(max_length=16, decoder_start_token_id=cfg.decoder_start_token_id,
                eos_token_id=cfg.eos_token_id, pad_token_id=cfg.pad_token_id,
                bos_token_id=cfg.bos_token_id,
                no_timestamps_token_id=cfg.no_timestamps_token_id,
                return_timestamps=True, return_token_timestamps=True,
                alignment_heads=HEADS)
    base.update(kw)
    return GenerationConfig(**base)


def _slots(jcfg):
    return alignment_slots_from_heads(HEADS, jcfg.decoder_layers,
                                      jcfg.decoder_attention_heads)


def test_decoder_cached_alignment_probs_match_jax(pair, rng):
    jcfg, params, _, model = pair
    enc = (rng.standard_normal((2, 300, 128)) * 2.0).astype(np.float32)
    ids = np.array([[jcfg.decoder_start_token_id, 1000, 1003, 40, 41],
                    [jcfg.decoder_start_token_id, 1000, 1003, 42, 43]])
    slots = _slots(jcfg)
    dec = model.decoder
    jcross = jw.precompute_cross_kv(params["decoder"], jcfg, jnp.asarray(enc))
    jh, _, jp = jw.decoder_cached(
        params["decoder"], jcfg, jnp.asarray(ids), 0,
        jw.init_kv_cache(jcfg, 2, 8), jcross,
        alignment_slots=jnp.asarray(slots))
    th, tp = dec.decoder_cached(
        torch.from_numpy(ids), 0, dec.init_kv_cache(2, 8, "cpu"),
        dec.precompute_cross_kv(torch.from_numpy(enc)),
        alignment_slots=torch.from_numpy(slots))
    assert tp.shape == (2, len(HEADS), 5, 300) and tp.dtype == torch.float32
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5)
    # each slot is one head's softmax: its rows sum to 1
    np.testing.assert_allclose(tp.sum(-1).numpy(), 1.0, atol=1e-5)


def test_greedy_collects_the_same_alignment_buffer(pair, rng):
    jcfg, params, _, model = pair
    gen_cfg = _gen_cfg(jcfg, max_length=15)
    enc = (rng.standard_normal((2, 300, 128)) * 2.0).astype(np.float32)
    prompt = np.tile(np.array([[jcfg.decoder_start_token_id, 1000, 1003]]),
                     (2, 1))
    slots = _slots(jcfg)
    ref = jax_greedy(params, jcfg, gen_cfg, jnp.asarray(enc),
                     jnp.asarray(prompt), 12,
                     alignment_slots=jnp.asarray(slots))
    out = greedy_decode(model, gen_cfg, torch.from_numpy(enc),
                        torch.from_numpy(prompt), 12,
                        alignment_slots=torch.from_numpy(slots))
    np.testing.assert_array_equal(out.sequences.numpy(),
                                  np.asarray(ref.sequences))
    assert out.alignment_weights.shape == (2, len(HEADS), 12, 300)
    np.testing.assert_allclose(out.alignment_weights.numpy(),
                               np.asarray(ref.alignment_weights), atol=1e-6)


def _batch(rng, valid=(1700, 1000), t_total=1800):
    feats = rng.standard_normal((2, 80, t_total)).astype(np.float32)
    att = np.zeros((2, t_total), np.int64)
    stno = np.zeros((2, 4, t_total // 2), np.float32)
    for i, n in enumerate(valid):
        att[i, :n] = 1
        feats[i, :, n:] = 0.0
        lab = rng.integers(0, 4, size=t_total // 2)
        stno[i, lab, np.arange(t_total // 2)] = 1.0
        stno[i, :, n // 2:] = 0.0
        stno[i, 0, n // 2:] = 1.0
    return feats, stno, att


def _segments(out):
    return [[(s.start, s.end, s.tokens.tolist(),
              None if s.token_timestamps is None
              else np.asarray(s.token_timestamps).tolist())
             for s in segs] for segs in out.segments]


@pytest.mark.parametrize("crop", [False, True], ids=["no_crop", "crop"])
def test_longform_token_timestamps_match_jax(pair, rng, crop):
    jcfg, params, _, model = pair
    gen_cfg = _gen_cfg(jcfg)
    feats, stno, att = _batch(rng)
    forced = np.tile(np.array([[jcfg.decoder_start_token_id, 1000, 1003]]),
                     (2, 1))
    kw = {"token_ts_num_frames": att.sum(-1)} if crop else {}
    ref = jlf.longform_generate(params, jcfg, gen_cfg, feats, stno, att,
                                forced, return_segments=True, **kw)
    out = tlf.longform_generate(model, gen_cfg, feats, stno, att, forced,
                                return_segments=True, **kw)
    np.testing.assert_array_equal(out.sequences, ref.sequences)
    assert out.windows_decoded == ref.windows_decoded > 2
    got, want = _segments(out), _segments(ref)
    assert got == want
    # every segment carries its tokens' times, within the recording
    segs = [s for row in got for s in row]
    assert segs and all(s[3] is not None for s in segs)
    assert max(t for s in segs for t in s[3]) <= 1800 * 0.01 + 1e-6


def test_beam_token_timestamps_raise_as_jax(pair):
    jcfg, params, _, model = pair
    gen_cfg = _gen_cfg(jcfg, num_beams=2)
    feats = np.zeros((1, 80, 600), np.float32)
    stno = np.full((1, 4, 300), 0.25, np.float32)
    att = np.ones((1, 600), np.int64)
    forced = np.array([[jcfg.decoder_start_token_id, 1000, 1003]])
    with pytest.raises(NotImplementedError):
        jlf.longform_generate(params, jcfg, gen_cfg, feats, stno, att, forced)
    with pytest.raises(NotImplementedError):
        tlf.longform_generate(model, gen_cfg, feats, stno, att, forced)
    for bad, exc in (({"alignment_heads": ()}, ValueError),
                     ({"cross_kv_quant": True}, (AssertionError,
                                                 ValueError))):
        gen_bad = _gen_cfg(jcfg, **bad)
        with pytest.raises(exc):
            jlf.longform_generate(params, jcfg, gen_bad, feats, stno, att,
                                  forced)
        with pytest.raises(ValueError):
            tlf.longform_generate(model, gen_bad, feats, stno, att, forced)


def test_decoder_cached_refuses_alignment_over_int8(pair):
    from ts_asr_whisper_tpu_torch.models.whisper import quantize_cross_kv

    jcfg, _, _, model = pair
    dec = model.decoder
    cross = quantize_cross_kv(dec.precompute_cross_kv(torch.zeros(1, 300,
                                                                  128)))
    with pytest.raises(ValueError, match="exact cross-KV"):
        dec.decoder_cached(torch.tensor([[jcfg.decoder_start_token_id]]), 0,
                           dec.init_kv_cache(1, 4, "cpu"), cross,
                           alignment_slots=torch.from_numpy(_slots(jcfg)))
