"""The port's joint-decode debug dump (``CTCRescorer(debug=True)``,
``gen_cfg.joint_debug``) against the JAX package's: over a short beam-3
joint-CTC decode on the same weights the printed tables are the same lines
(per hypothesis: the prefix, the top 10 by attention, by CTC with the
timestamps blanked and fused, and the CTC EOS score), with token ids and
with a registered token decoder."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_utils import make_pair
from ts_asr_whisper_tpu.decoding import ctc_rescorer as jctc
from ts_asr_whisper_tpu.decoding.beam import beam_search as jax_beam
from ts_asr_whisper_tpu.decoding.generation_config import GenerationConfig
from ts_asr_whisper_tpu.models.dicow import encoder_ctc_logits
from ts_asr_whisper_tpu_torch.decoding import ctc_rescorer as tctc
from ts_asr_whisper_tpu_torch.decoding.beam import beam_search

MAX_NEW = 4
N = 3


def _decoder(ids):
    return "".join(chr(97 + int(i) % 26) for i in ids)


@pytest.fixture(scope="module")
def setup():
    jcfg, params, _, model = make_pair(seed=5)
    rng = np.random.default_rng(12)
    enc = (rng.standard_normal((2, 300, 128)) * 2.0).astype(np.float32)
    prompt = np.tile(np.array([[jcfg.decoder_start_token_id, 1000, 1003]]),
                     (2, 1))
    gen_cfg = GenerationConfig(
        max_length=3 + MAX_NEW,
        decoder_start_token_id=jcfg.decoder_start_token_id,
        eos_token_id=jcfg.eos_token_id, pad_token_id=jcfg.pad_token_id,
        bos_token_id=jcfg.bos_token_id,
        no_timestamps_token_id=jcfg.no_timestamps_token_id,
        return_timestamps=True, length_penalty=0.1, ctc_weight=0.2,
        joint_debug=True)
    return jcfg, params, model, enc, prompt, gen_cfg


def _dump(setup, capsys, decode_fn):
    jcfg, params, model, enc, prompt, gen_cfg = setup
    blank = jcfg.ctc_vocab_size - 1
    kw = dict(blank_id=blank, eos_id=jcfg.eos_token_id,
              timestamp_begin=gen_cfg.timestamp_begin, ctc_weight=0.2,
              k=min(500, gen_cfg.timestamp_begin - 1), prefix_len=3,
              debug=True)
    logits = encoder_ctc_logits(params["encoder"], jcfg, jnp.asarray(enc))
    js = jctc.CTCRescorer(**kw)
    ts = tctc.CTCRescorer(**kw)
    jctc.set_joint_debug_decoder(decode_fn)
    tctc.set_joint_debug_decoder(decode_fn)
    try:
        capsys.readouterr()
        jax_beam(params, jcfg, gen_cfg, jnp.asarray(enc), jnp.asarray(prompt),
                 MAX_NEW, num_beams=N, ctc_scorer=js,
                 ctc_state=jctc.init_ctc_state(logits, blank, num_beams=N,
                                               k=js.k))
        jax.effects_barrier()
        ref = capsys.readouterr().out
        with torch.no_grad():
            beam_search(model, gen_cfg, torch.from_numpy(enc),
                        torch.from_numpy(prompt), MAX_NEW, N, ts,
                        tctc.init_ctc_state(torch.from_numpy(np.array(logits)),
                                            blank, num_beams=N, k=ts.k))
        out = capsys.readouterr().out
    finally:
        jctc.set_joint_debug_decoder(None)
        tctc.set_joint_debug_decoder(None)
    return out, ref


@pytest.mark.parametrize("decode_fn", [None, _decoder], ids=["ids", "text"])
def test_debug_dump_matches_jax(setup, capsys, decode_fn):
    out, ref = _dump(setup, capsys, decode_fn)
    lines = out.splitlines()
    assert lines == ref.splitlines()
    # one table per beam step, one block per hypothesis
    steps = lines.count("#" * 100) // 2
    assert 0 < steps <= MAX_NEW
    assert lines.count("HYPOTHESIS 0") == steps
    assert sum(line.startswith("HYPOTHESIS ") for line in lines) \
        == 2 * N * steps
    assert sum(line.startswith("CTC_TOKENS: ") for line in lines) \
        == 2 * N * steps


def test_no_dump_without_debug(setup, capsys):
    jcfg, _, model, enc, prompt, gen_cfg = setup
    blank = jcfg.ctc_vocab_size - 1
    ts = tctc.CTCRescorer(blank_id=blank, eos_id=jcfg.eos_token_id,
                          timestamp_begin=gen_cfg.timestamp_begin,
                          ctc_weight=0.2, k=100, prefix_len=3)
    logits = torch.zeros(2, 75, jcfg.ctc_vocab_size)
    capsys.readouterr()
    with torch.no_grad():
        beam_search(model, gen_cfg, torch.from_numpy(enc),
                    torch.from_numpy(prompt), MAX_NEW, N, ts,
                    tctc.init_ctc_state(logits, blank, num_beams=N, k=ts.k))
    assert capsys.readouterr().out == ""
