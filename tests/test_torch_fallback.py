"""Temperature-fallback retries of the port's seek loop against the JAX
package's (longform.py:573-641), and the sampler they use.

Sampling cannot match ``jax.random`` bit for bit, so the control flow is
held with the ladder (0.0, 0.0): the retry decodes by argmax on both sides
and every retried row is token-exact. Thresholds that every row fails and
that only some rows fail; greedy, greedy + CTC and beam + CTC first passes
(a beam pass retries greedy from a fresh single-hypothesis CTC state).
No-speech-skip rows never retry. The sampler is held to the distribution:
a chi-square test of >= 20k draws against softmax(scores / T) at p > 1e-3,
no -inf token ever drawn, one seed one sequence."""

import numpy as np
import pytest
import torch
from scipy import stats

from torch_parity_utils import make_pair
from ts_asr_whisper_tpu.decoding import longform as jlf
from ts_asr_whisper_tpu.decoding.generation_config import GenerationConfig
from ts_asr_whisper_tpu_torch.decoding import greedy as tgreedy
from ts_asr_whisper_tpu_torch.decoding import longform as tlf

FIRST_PASS = {
    "greedy": {},
    "greedy_ctc": {"ctc_weight": 0.2},
    "beam_ctc": {"num_beams": 3, "ctc_weight": 0.2, "length_penalty": 0.1},
}
U2L = np.stack([np.arange(100, 160), np.arange(300, 360)])


@pytest.fixture(scope="module")
def pair():
    return make_pair(seed=9)


def _gen_cfg(cfg, **kw):
    base = dict(max_length=16, decoder_start_token_id=cfg.decoder_start_token_id,
                eos_token_id=cfg.eos_token_id, pad_token_id=cfg.pad_token_id,
                bos_token_id=cfg.bos_token_id,
                no_timestamps_token_id=cfg.no_timestamps_token_id,
                return_timestamps=True, temperature=(0.0, 0.0))
    base.update(kw)
    return GenerationConfig(**base)


def _batch(rng, valid=(1700, 1000, 350, 1200), t_total=1800):
    b = len(valid)
    feats = rng.standard_normal((b, 80, t_total)).astype(np.float32)
    att = np.zeros((b, t_total), np.int64)
    stno = np.zeros((b, 4, t_total // 2), np.float32)
    for i, n in enumerate(valid):
        att[i, :n] = 1
        feats[i, :, n:] = 0.0
        lab = rng.integers(0, 4, size=t_total // 2)
        stno[i, lab, np.arange(t_total // 2)] = 1.0
        stno[i, :, n // 2:] = 0.0
        stno[i, 0, n // 2:] = 1.0
    forced = np.tile(np.array([[1998, 1000, 1003]]), (b, 1))
    return feats, stno, att, forced


def _watch(monkeypatch):
    """Record the port's quality checks (avg logprob, verdict) and the
    temperature of each greedy call (None for a first pass)."""
    checks, temps = [], []
    needs = tlf._needs_fallback
    greedy = tlf.greedy_decode

    def watched_needs(tokens, avg_logprob, gen_cfg, vocab_size):
        out = needs(tokens, avg_logprob, gen_cfg, vocab_size)
        checks.append((float(avg_logprob), out))
        return out

    def watched_greedy(*args, **kwargs):
        temps.append(kwargs.get("temperature"))
        return greedy(*args, **kwargs)

    monkeypatch.setattr(tlf, "_needs_fallback", watched_needs)
    monkeypatch.setattr(tlf, "greedy_decode", watched_greedy)
    return checks, temps


def _run_both(pair, gen_cfg, batch):
    jcfg, params, _, model = pair
    feats, stno, att, forced = batch
    ref = jlf.longform_generate(params, jcfg, gen_cfg, feats, stno, att,
                                forced, return_segments=True,
                                upper_to_lower=U2L)
    out = tlf.longform_generate(model, gen_cfg, feats, stno, att, forced,
                                return_segments=True, upper_to_lower=U2L)
    np.testing.assert_array_equal(out.sequences, ref.sequences)
    assert out.windows_decoded == ref.windows_decoded
    assert [[(s.start, s.end, s.tokens.tolist()) for s in segs]
            for segs in out.segments] == \
        [[(s.start, s.end, s.tokens.tolist()) for s in segs]
         for segs in ref.segments]
    return out


def _differs(a, b):
    return a.sequences.shape != b.sequences.shape or \
        (a.sequences != b.sequences).any()


def _split_threshold(pair, batch, first, checks):
    """A log-prob threshold between the first window's average log-probs,
    so that some rows fail there and some pass. After a beam pass the
    greedy retry gives other tokens, so there it must also be one at which
    the hypotheses differ both from no retry and from retrying every row:
    kept and retried rows both show in the output."""
    jcfg, model, kw = pair[0], pair[3], FIRST_PASS[first]

    def run(**gen):
        with torch.no_grad():
            return tlf.longform_generate(model, _gen_cfg(jcfg, **gen, **kw),
                                         *batch, upper_to_lower=U2L)

    every = run(logprob_threshold=0.0)
    lps = sorted(lp for lp, _ in checks[:len(batch[0])])
    candidates = [(x + y) / 2 for x, y in zip(lps, lps[1:])]
    if first != "beam_ctc":
        return candidates[len(candidates) // 2]
    none = run(temperature=(0.0,))
    for threshold in candidates:
        out = run(logprob_threshold=threshold)
        if _differs(out, none) and _differs(out, every):
            return threshold
    pytest.fail(f"no threshold among {candidates} keeps and retries rows "
                "that show in the output")


@pytest.mark.parametrize("share", ["all", "some"])
@pytest.mark.parametrize("first", sorted(FIRST_PASS))
def test_fallback_ladder_matches_jax(pair, rng, monkeypatch, first, share):
    jcfg = pair[0]
    batch = _batch(rng)
    kw = FIRST_PASS[first]
    checks, temps = _watch(monkeypatch)
    # every average log-prob is below 0: every row fails
    threshold = 0.0
    if share == "some":
        threshold = _split_threshold(pair, batch, first, checks)
        checks.clear()
        temps.clear()
    _run_both(pair, _gen_cfg(jcfg, logprob_threshold=threshold, **kw), batch)
    verdicts = [v for _, v in checks]
    assert verdicts and any(verdicts)
    if share == "all":
        assert all(verdicts)
    else:
        assert not all(verdicts)
    # retries ran, at the ladder's 0.0
    retries = [t for t in temps if t is not None]
    assert retries and set(retries) == {0.0}


def test_no_speech_skip_rows_never_retry(pair, rng, monkeypatch):
    """Both thresholds at 0: every row's no-speech prob exceeds 0 and its
    average log-prob is below 0, so every row is skipped as silence and
    none retries, though each fails the log-prob check."""
    jcfg = pair[0]
    checks, temps = _watch(monkeypatch)
    _run_both(pair, _gen_cfg(jcfg, temperature=(0.0, 0.4),
                             logprob_threshold=0.0, no_speech_threshold=0.0),
              _batch(rng))
    assert checks == []
    assert temps and all(t is None for t in temps)


def test_sampled_retries_are_seeded(pair, rng):
    """A ladder of (0.0, 1.0) samples its retries from a generator seeded by
    the window's seek: the same call twice gives the same hypotheses."""
    jcfg, _, _, model = pair
    gen_cfg = _gen_cfg(jcfg, temperature=(0.0, 1.0), logprob_threshold=0.0)
    batch = _batch(rng, valid=(1200, 700))
    with torch.no_grad():
        a = tlf.longform_generate(model, gen_cfg, *batch)
        b = tlf.longform_generate(model, gen_cfg, *batch)
        greedy = tlf.longform_generate(
            model, _gen_cfg(jcfg, temperature=(0.0,)), *batch)
    np.testing.assert_array_equal(a.sequences, b.sequences)
    assert a.sequences.shape != greedy.sequences.shape or \
        (a.sequences != greedy.sequences).any()


@pytest.mark.parametrize("temperature", [0.5, 1.0])
def test_sampler_follows_the_tempered_softmax(temperature):
    rng = np.random.default_rng(3)
    scores = rng.standard_normal(12).astype(np.float32) * 1.5
    scores[[2, 7]] = -np.inf                      # suppressed tokens
    n = 24000
    rows = torch.from_numpy(scores).expand(n, -1).contiguous()
    gen = torch.Generator().manual_seed(5)
    draws = tgreedy.sample(rows, temperature, gen).numpy()
    counts = np.bincount(draws, minlength=12)
    assert counts[[2, 7]].sum() == 0
    s64 = scores.astype(np.float64)
    p = np.exp((s64 - s64[np.isfinite(s64)].max()) / temperature)
    p /= p.sum()
    live = p > 0
    _, pval = stats.chisquare(counts[live], n * p[live])
    assert pval > 1e-3, (counts, n * p)


def test_sampler_never_draws_minus_inf():
    rng = np.random.default_rng(4)
    scores = torch.from_numpy(rng.standard_normal((4000, 64))
                              .astype(np.float32) * 3)
    scores[:, ::2] = -torch.inf
    draws = tgreedy.sample(scores, 1.0, torch.Generator().manual_seed(0))
    assert (draws % 2 == 1).all()


def test_one_seed_one_sequence(pair, rng):
    jcfg, _, _, model = pair
    gen_cfg = _gen_cfg(jcfg, max_length=23)
    enc = torch.from_numpy((rng.standard_normal((2, 300, 128)) * 2.0)
                           .astype(np.float32))
    prompt = torch.tensor([[1998, 1000, 1003]] * 2)

    def run(seed):
        with torch.no_grad():
            return tgreedy.greedy_decode(
                model, gen_cfg, enc, prompt, 20, temperature=1.0,
                generator=torch.Generator().manual_seed(seed)).sequences

    a, b, c = run(7), run(7), run(8)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
