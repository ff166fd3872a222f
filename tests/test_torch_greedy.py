"""Port greedy decode (timestamp rules, suppression, repetition penalty) vs
the JAX package's ``greedy_decode`` on the same weights and encoder states:
tokens exact, sum_logprobs within 1e-4, no-speech probs within 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_utils import make_pair
from ts_asr_whisper_tpu.decoding.generation_config import GenerationConfig
from ts_asr_whisper_tpu.decoding.greedy import greedy_decode as jax_greedy
from ts_asr_whisper_tpu.decoding.logits_process import (
    make_logits_processor as jax_processor,
)
from ts_asr_whisper_tpu_torch.decoding.greedy import greedy_decode
from ts_asr_whisper_tpu_torch.decoding.logits_process import (
    make_logits_processor,
)


def _gen_cfg(cfg, **kw):
    base = dict(max_length=24, decoder_start_token_id=cfg.decoder_start_token_id,
                eos_token_id=cfg.eos_token_id, pad_token_id=cfg.pad_token_id,
                bos_token_id=cfg.bos_token_id,
                no_timestamps_token_id=cfg.no_timestamps_token_id,
                return_timestamps=True, suppress_tokens=(5, 17, 300),
                begin_suppress_tokens=(220,))
    base.update(kw)
    return GenerationConfig(**base)


CASES = {
    "timestamps": {},
    "timestamps_max_initial": {"max_initial_timestamp_index": 10},
    "no_timestamps": {"return_timestamps": False},
    "repetition_penalty": {"repetition_penalty": 1.3},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_greedy_parity(rng, case):
    jcfg, params, _, model = make_pair(seed=1)
    gen_cfg = _gen_cfg(jcfg, **CASES[case])
    b = 3
    enc = (rng.standard_normal((b, 300, 128)) * 2.0).astype(np.float32)
    prompt = np.tile(np.array([[jcfg.decoder_start_token_id, 1000, 1001]]),
                     (b, 1))
    ref = jax_greedy(params, jcfg, gen_cfg, jnp.asarray(enc),
                     jnp.asarray(prompt), 20)
    out = greedy_decode(model, gen_cfg, torch.from_numpy(enc),
                        torch.from_numpy(prompt), 20)
    np.testing.assert_array_equal(out.sequences.numpy(),
                                  np.asarray(ref.sequences))
    np.testing.assert_array_equal(out.lengths.numpy(),
                                  np.asarray(ref.lengths))
    np.testing.assert_allclose(out.sum_logprobs.numpy(),
                               np.asarray(ref.sum_logprobs), atol=1e-4)
    np.testing.assert_allclose(out.no_speech_probs.numpy(),
                               np.asarray(ref.no_speech_probs), atol=1e-5)


def test_processor_parity_stepwise(rng):
    """The processor chain alone, at the begin step and mid-sequence, on
    token buffers that hit every timestamp rule."""
    v = 2000
    ts = 499
    gen_cfg = GenerationConfig(no_timestamps_token_id=ts - 1, eos_token_id=1997,
                               pad_token_id=1997, return_timestamps=True,
                               suppress_tokens=(3, 4),
                               begin_suppress_tokens=(220,),
                               max_initial_timestamp_index=50,
                               repetition_penalty=1.2)
    prompt = 3
    toks = np.full((5, 10), 1997)
    toks[:, :prompt] = [1998, 1000, 1001]
    toks[0, 3:6] = [ts + 4, 10, ts + 9]         # last ts, penult text
    toks[1, 3:6] = [ts + 4, ts + 9, ts + 9]     # two timestamps
    toks[2, 3:6] = [ts + 2, 11, 12]             # text after a timestamp
    toks[3, 3:6] = [10, 11, 12]                 # no timestamps
    toks[4, 3:6] = [ts, 40, 41]
    for cur_len in (prompt, 6):
        scores = (rng.standard_normal((5, v)) * 3).astype(np.float32)
        scores[4, ts:] += 6.0  # timestamp mass beats every text token
        ref = np.asarray(jax_processor(gen_cfg, prompt)(
            jnp.asarray(scores), jnp.asarray(toks), cur_len))
        out = make_logits_processor(gen_cfg, prompt)(
            torch.from_numpy(scores), torch.from_numpy(toks), cur_len)
        np.testing.assert_array_equal(out.numpy(), ref)


def test_eos_early_exit_and_padding(rng):
    """Rows that emit EOS at different steps: finished rows are pad-filled,
    lengths stop at the first EOS, and the loop exits once all have
    finished -- exactly as the JAX loop. Token 1270 is one these weights emit
    within a few steps, so it serves as EOS here."""
    jcfg, params, _, model = make_pair(seed=1)
    gen_cfg = _gen_cfg(jcfg, return_timestamps=False, eos_token_id=1270)
    rng.standard_normal((3, 300, 128))  # the draw of test_greedy_parity
    enc = (rng.standard_normal((3, 300, 128)) * 2.0).astype(np.float32)
    prompt = np.tile(np.array([[jcfg.decoder_start_token_id, 1000, 1001]]),
                     (3, 1))
    ref = jax_greedy(params, jcfg, gen_cfg, jnp.asarray(enc),
                     jnp.asarray(prompt), 20)
    out = greedy_decode(model, gen_cfg, torch.from_numpy(enc),
                        torch.from_numpy(prompt), 20)
    seq, lengths = out.sequences.numpy(), out.lengths.numpy()
    np.testing.assert_array_equal(seq, np.asarray(ref.sequences))
    np.testing.assert_array_equal(lengths, np.asarray(ref.lengths))
    assert len(set(lengths.tolist())) > 1 and lengths.max() < seq.shape[1]
    for r in range(3):
        assert seq[r, lengths[r] - 1] == 1270
        assert (seq[r, lengths[r]:] == jcfg.pad_token_id).all()
