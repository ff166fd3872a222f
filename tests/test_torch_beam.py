"""Port ``beam_search`` (append-only ancestry cache) vs the JAX package's
``beam_search`` on the CPU (whose cache reorder is the one-hot permute
there) on the same weights and encoder states, with and without joint CTC:
tokens and lengths exact, scores and no-speech probs within 2e-5. Also:
n=1 equals greedy, and exact logit ties break as ``lax.top_k`` breaks
them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_utils import make_pair
from ts_asr_whisper_tpu.decoding import ctc_rescorer as jctc
from ts_asr_whisper_tpu.decoding.beam import beam_search as jax_beam
from ts_asr_whisper_tpu.decoding.generation_config import GenerationConfig
from ts_asr_whisper_tpu.models.dicow import encoder_ctc_logits
from ts_asr_whisper_tpu_torch.decoding import beam as B
from ts_asr_whisper_tpu_torch.decoding import ctc_rescorer as tctc
from ts_asr_whisper_tpu_torch.decoding.greedy import greedy_decode
from ts_asr_whisper_tpu_torch.kernels import launch_counts

MAX_NEW = 12
U2L = np.stack([np.arange(100, 140), np.arange(300, 340)])


def _gen_cfg(cfg, **kw):
    base = dict(max_length=3 + MAX_NEW,
                decoder_start_token_id=cfg.decoder_start_token_id,
                eos_token_id=cfg.eos_token_id, pad_token_id=cfg.pad_token_id,
                bos_token_id=cfg.bos_token_id,
                no_timestamps_token_id=cfg.no_timestamps_token_id,
                return_timestamps=True, length_penalty=0.1)
    base.update(kw)
    return GenerationConfig(**base)


def _setup(rng, seed=3, tie_rows=None):
    jcfg, params, _, model = make_pair(seed=seed)
    if tie_rows is not None:
        # duplicate token embeddings: exact logit ties on both sides
        lo, hi = tie_rows
        emb = np.asarray(params["decoder"]["embed_tokens"]).copy()
        emb[lo:hi] = emb[lo - 1]
        params["decoder"]["embed_tokens"] = jnp.asarray(emb)
        with torch.no_grad():
            model.decoder.embed_tokens.weight.copy_(torch.from_numpy(emb))
    enc = (rng.standard_normal((2, 300, 128)) * 2.0).astype(np.float32)
    prompt = np.tile(np.array([[jcfg.decoder_start_token_id, 1000, 1003]]),
                     (2, 1))
    return jcfg, params, model, enc, prompt


def _scorers(jcfg, params, enc, n, ts_begin):
    blank = jcfg.ctc_vocab_size - 1
    kw = dict(blank_id=blank, eos_id=jcfg.eos_token_id,
              timestamp_begin=ts_begin, ctc_weight=0.2,
              k=min(500, ts_begin - 1), prefix_len=3)
    logits = encoder_ctc_logits(params["encoder"], jcfg, jnp.asarray(enc))
    js = jctc.CTCRescorer(**kw)
    jst = jctc.init_ctc_state(logits, blank, U2L, num_beams=n, k=js.k)
    ts = tctc.CTCRescorer(**kw)
    tst = tctc.init_ctc_state(torch.from_numpy(np.array(logits)), blank,
                              U2L, num_beams=n, k=ts.k)
    return (js, jst), (ts, tst)


def _compare(out, ref):
    np.testing.assert_array_equal(out.sequences.numpy(),
                                  np.asarray(ref.sequences))
    np.testing.assert_array_equal(out.lengths.numpy(),
                                  np.asarray(ref.lengths))
    np.testing.assert_allclose(out.scores.numpy(), np.asarray(ref.scores),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out.no_speech_probs.numpy(),
                               np.asarray(ref.no_speech_probs), atol=2e-5)


@pytest.mark.parametrize("ctc", [False, True], ids=["no_ctc", "joint_ctc"])
@pytest.mark.parametrize("n", [1, 3, 5])
def test_beam_parity(rng, n, ctc):
    jcfg, params, model, enc, prompt = _setup(rng)
    gen_cfg = _gen_cfg(jcfg)
    jargs, targs = {}, {}
    if ctc:
        (js, jst), (ts, tst) = _scorers(jcfg, params, enc, n,
                                        gen_cfg.timestamp_begin)
        jargs = dict(ctc_scorer=js, ctc_state=jst)
        targs = dict(ctc_scorer=ts, ctc_state=tst)
    ref = jax_beam(params, jcfg, gen_cfg, jnp.asarray(enc),
                   jnp.asarray(prompt), MAX_NEW, num_beams=n, **jargs)
    steps0 = B.counters["beam_steps"]
    launches0 = dict(launch_counts)
    out = B.beam_search(model, gen_cfg, torch.from_numpy(enc),
                        torch.from_numpy(prompt), MAX_NEW, n, **targs)
    _compare(out, ref)
    assert 0 < B.counters["beam_steps"] - steps0 <= MAX_NEW
    assert launch_counts == launches0  # CPU: no kernel launches
    # the decode is not degenerate: text tokens beyond the prompt
    assert (out.sequences[:, 3:] < gen_cfg.timestamp_begin).any()


def test_beam1_equals_greedy(rng):
    jcfg, _, model, enc, prompt = _setup(rng)
    gen_cfg = _gen_cfg(jcfg)
    g = greedy_decode(model, gen_cfg, torch.from_numpy(enc),
                      torch.from_numpy(prompt), MAX_NEW)
    bm = B.beam_search(model, gen_cfg, torch.from_numpy(enc),
                       torch.from_numpy(prompt), MAX_NEW, 1)
    for i in range(2):
        m = int(min(g.lengths[i], bm.lengths[i]))
        assert g.sequences[i, :m].tolist() == bm.sequences[i, :m].tolist()


def test_beam_tie_rule_matches_lax_top_k(rng):
    """Tokens 760-799 share one embedding, so their logits tie exactly at
    every step. On these weights 760 is among the likeliest continuations,
    so the 2n candidates of a step hold many exact ties; beams pick among
    them lower index first, as lax.top_k."""
    jcfg, params, model, enc, prompt = _setup(rng, tie_rows=(761, 800))
    gen_cfg = _gen_cfg(jcfg, return_timestamps=False)
    enc = enc * 0.0
    ref = jax_beam(params, jcfg, gen_cfg, jnp.asarray(enc),
                   jnp.asarray(prompt), MAX_NEW, num_beams=5)
    out = B.beam_search(model, gen_cfg, torch.from_numpy(enc),
                        torch.from_numpy(prompt), MAX_NEW, 5)
    _compare(out, ref)
    seq = out.sequences.numpy()[:, 3:]
    assert ((seq >= 760) & (seq < 800)).any(), seq
