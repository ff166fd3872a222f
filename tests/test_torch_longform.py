"""Port ``longform_generate`` vs the JAX package's on the same weights:
multi-window recordings of unequal lengths in one batch of 3, so that the
seek loop, the power-of-2 compaction with duplicate rows and the re-blocking
all run, greedy and beam, with and without joint CTC (the same case-fold map
on both sides). Sequences exact, ``windows_decoded`` equal."""

import numpy as np
import pytest
import torch

from torch_parity_utils import make_pair
from ts_asr_whisper_tpu.decoding import longform as jlf
from ts_asr_whisper_tpu.decoding.generation_config import GenerationConfig
from ts_asr_whisper_tpu_torch.decoding import longform as tlf


def _batch(rng, valid=(1700, 1000, 350), t_total=1800, n_mels=80):
    feats = rng.standard_normal((3, n_mels, t_total)).astype(np.float32)
    att = np.zeros((3, t_total), np.int64)
    stno = np.zeros((3, 4, t_total // 2), np.float32)
    for i, n in enumerate(valid):
        att[i, :n] = 1
        feats[i, :, n:] = 0.0
        lab = rng.integers(0, 4, size=t_total // 2)
        stno[i, lab, np.arange(t_total // 2)] = 1.0
        stno[i, :, n // 2:] = 0.0
        stno[i, 0, n // 2:] = 1.0
    return feats, stno, att


def _gen_cfg(cfg, **kw):
    base = dict(max_length=16, decoder_start_token_id=cfg.decoder_start_token_id,
                eos_token_id=cfg.eos_token_id, pad_token_id=cfg.pad_token_id,
                bos_token_id=cfg.bos_token_id,
                no_timestamps_token_id=cfg.no_timestamps_token_id,
                return_timestamps=True, lang_ids=(1000, 1001, 1002))
    base.update(kw)
    return GenerationConfig(**base)


CASES = {
    "forced_language": ({}, False),
    "detect_language": ({}, True),
    # the no-speech skip: HF's rule needs both thresholds
    "no_speech_skip": ({"no_speech_threshold": 0.0,
                        "logprob_threshold": 0.0}, False),
    # dicow_v3_beam_joint's decode settings
    "beam_joint_ctc": ({"num_beams": 5, "ctc_weight": 0.2,
                        "length_penalty": 0.1}, False),
    "beam_no_ctc": ({"num_beams": 3, "length_penalty": 0.1}, False),
    "greedy_ctc": ({"ctc_weight": 0.2}, False),
}
# upper-case token ids -> lower-case ids, as the tokenizer's map gives them
UPPER_TO_LOWER = np.stack([np.arange(100, 160), np.arange(300, 360)])


@pytest.mark.parametrize("case", sorted(CASES))
def test_longform_parity(rng, case):
    overrides, detect = CASES[case]
    jcfg, params, _, model = make_pair(seed=4)
    gen_cfg = _gen_cfg(jcfg, **overrides)
    feats, stno, att = _batch(rng)
    forced = np.tile(np.array([[jcfg.decoder_start_token_id, 1000, 1003]]),
                     (3, 1))
    ref = jlf.longform_generate(params, jcfg, gen_cfg, feats, stno, att,
                                forced, detect_lang=detect,
                                return_segments=True,
                                upper_to_lower=UPPER_TO_LOWER)
    out = tlf.longform_generate(model, gen_cfg, feats, stno, att, forced,
                                detect_lang=detect, return_segments=True,
                                upper_to_lower=UPPER_TO_LOWER)
    np.testing.assert_array_equal(out.sequences, ref.sequences)
    assert out.windows_decoded == ref.windows_decoded
    assert [[(s.start, s.end, s.tokens.tolist()) for s in segs]
            for segs in out.segments] == \
        [[(s.start, s.end, s.tokens.tolist()) for s in segs]
         for segs in ref.segments]
    # three recordings of different lengths: more windows than rows
    assert out.windows_decoded > 3


def test_slice_windows_tail_semantics(rng):
    """Mel tail zeroed, STNO tail set to silence, row ids and seek offsets
    honoured (longform.py:41-67)."""
    feats = torch.from_numpy(rng.standard_normal((2, 3, 40)).astype(
        np.float32))
    stno = torch.from_numpy(rng.random((2, 4, 20)).astype(np.float32))
    meta = np.array([[1, 0], [4, 2], [10, 16], [3, 8]])  # rows, seek, nm, ns
    w, s = tlf.slice_windows(feats, stno, meta, nsf=16)
    assert w.shape == (2, 3, 16) and s.shape == (2, 4, 8)
    np.testing.assert_array_equal(w[0, :, :10], feats[1, :, 4:14])
    assert (w[0, :, 10:] == 0).all()
    np.testing.assert_array_equal(w[1], feats[0, :, 2:18])
    np.testing.assert_array_equal(s[0, :, :3], stno[1, :, 2:5])
    assert (s[0, 1:, 3:] == 0).all() and (s[0, 0, 3:] == 1).all()
    np.testing.assert_array_equal(s[1], stno[0, :, 1:9])


@pytest.mark.parametrize("field,value", [
    ("return_token_timestamps", True), ("cross_kv_quant", True),
    ("joint_debug", True)])
def test_out_of_slice_options_raise(field, value):
    """Each option alone is accepted now; what still raises is what the JAX
    package refuses (longform.py:379-395, whisper.py:542-543): token
    timestamps under beam search or without alignment heads, and alignment
    collection over the int8 cache."""
    heads = {"alignment_heads": ((1, 0),)}
    tlf.check_scope(GenerationConfig(**{field: value, **heads}))
    refused = {
        "return_token_timestamps": [
            (NotImplementedError, {"num_beams": 2, **heads}),
            (ValueError, {})],
        "cross_kv_quant": [
            (ValueError, {"return_token_timestamps": True, **heads})],
        "joint_debug": [
            (NotImplementedError, {"return_token_timestamps": True,
                                   "num_beams": 5, **heads})],
    }[field]
    for exc, kw in refused:
        with pytest.raises(exc):
            tlf.check_scope(GenerationConfig(**{field: value, **kw}))


def test_temperature_fallback_raises():
    """The fallback ladder is accepted now (the retries run in
    test_torch_fallback.py); under it, beam search with token timestamps
    still raises as the JAX package raises."""
    gen_cfg = GenerationConfig(temperature=(0.0, 0.2), logprob_threshold=-1.0)
    tlf.check_scope(gen_cfg)
    tlf.check_scope(GenerationConfig(temperature=(0.0, 0.2)))  # no checks
    with pytest.raises(NotImplementedError, match="greedy"):
        tlf.check_scope(GenerationConfig(
            temperature=(0.0, 0.2), logprob_threshold=-1.0, num_beams=5,
            return_token_timestamps=True, alignment_heads=((0, 0),)))
