"""The greedy step on the decoder's pooled static buffers
(``models/whisper.py``: ``greedy_buffers``, ``decoder_step``, the branch of
``decoder_cached`` that takes them) against the eager step; the buffers'
reuse from one decode to the next; the calls that stay eager; and the calls
that the benchmark's decode cell wraps on the instance, counts and reads:
``decoder_cached`` once a step, ``lm_logits`` once a step with that step's
logits. The CUDA graph that replays the same step is held
to it on the card in ``tests/test_torch_greedy_graph_cuda.py``."""

import copy
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from torch_parity_utils import make_pair
from ts_asr_whisper_tpu_torch.decoding.generation_config import \
    GenerationConfig
from ts_asr_whisper_tpu_torch.decoding.greedy import greedy_decode
from ts_asr_whisper_tpu_torch.models import whisper as W
from ts_asr_whisper_tpu_torch.utils import observability as obs


def _gen_cfg(cfg, **kw):
    return GenerationConfig(**{
        "max_length": 24, "decoder_start_token_id": cfg.decoder_start_token_id,
        "eos_token_id": cfg.eos_token_id, "pad_token_id": cfg.pad_token_id,
        "bos_token_id": cfg.bos_token_id,
        "no_timestamps_token_id": cfg.no_timestamps_token_id,
        "return_timestamps": True, "suppress_tokens": (5, 17, 300),
        "begin_suppress_tokens": (220,), **kw})


def _enc(seed, b, t_enc=300, d=128):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        (rng.standard_normal((b, t_enc, d)) * 2.0).astype(np.float32))


def _prompt(cfg, b, tail=(1000, 1001)):
    return torch.tensor([[cfg.decoder_start_token_id, *tail]] * b)


def _rel(a, b):
    return float((a - b).norm() / b.norm())


class _Calls:
    """Wraps a bound method on its instance, as the benchmark does, and
    keeps each call's return."""

    def __init__(self, obj, name, keep=False):
        self.obj, self.name, self.keep, self.returns = obj, name, keep, []
        self.n = 0
        fn = getattr(obj, name)

        def wrapped(*a, **k):
            self.n += 1
            out = fn(*a, **k)
            if self.keep:
                self.returns.append(out.clone())
            return out
        setattr(obj, name, wrapped)

    def restore(self):
        delattr(self.obj, self.name)


@pytest.fixture
def model():
    return make_pair(seed=1)


@pytest.fixture
def layout():
    yield
    W.set_kv_cache_layout("bhtd")


@pytest.mark.parametrize("kv_layout", W.KV_LAYOUTS)
@pytest.mark.parametrize("prompt_len", [1, 3])
@pytest.mark.parametrize("b", [3, 1])
def test_static_step_matches_eager_step(model, layout, b, prompt_len,
                                        kv_layout):
    """20 single-token steps on the pooled buffers (``decoder_step``,
    reached through ``decoder_cached``) after the prompt's prefill, against
    the eager step on a fresh cache: hidden and cache within 1e-5
    relative."""
    _, _, tcfg, m = model
    W.set_kv_cache_layout(kv_layout)
    dec = m.decoder
    enc = _enc(b, b)
    total = prompt_len + 20
    ids = torch.from_numpy(np.random.default_rng(7).integers(
        0, 1990, (b, total)))
    ids[:, 0] = tcfg.decoder_start_token_id
    cache_e = dec.init_kv_cache(b, total, torch.device("cpu"))
    cross_e = dec.precompute_cross_kv(enc)
    cache_s, cross_s = dec.greedy_buffers(enc, b, total, False)
    steps = _Calls(dec, "decoder_step")
    try:
        with torch.no_grad():
            h_e = dec.decoder_cached(ids[:, :prompt_len], 0, cache_e, cross_e)
            h_s = dec.decoder_cached(ids[:, :prompt_len], 0, cache_s, cross_s)
            # a prompt of one token is a single-token step too
            assert _rel(h_s, h_e) <= 1e-5 and steps.n == (prompt_len == 1)
            for pos in range(prompt_len, total):
                h_e = dec.decoder_cached(ids[:, pos:pos + 1], pos, cache_e,
                                         cross_e)
                h_s = dec.decoder_cached(ids[:, pos:pos + 1], pos, cache_s,
                                         cross_s)
                assert h_s.shape == h_e.shape == (b, 1, tcfg.d_model)
                assert _rel(h_s, h_e) <= 1e-5, pos
    finally:
        steps.restore()
    assert steps.n == 20 + (prompt_len == 1)
    for key in ("k", "v"):
        assert _rel(cache_s[key], cache_e[key]) <= 1e-5


def test_buffers_reused_and_refilled(model):
    """Two decodes at one key run on the same buffers; the second, on
    another encoder state and another prompt, equals a fresh decoder's. A
    second batch size gets buffers of its own."""
    _, _, tcfg, m = model
    fresh = copy.deepcopy(m)
    gen_cfg = _gen_cfg(tcfg)
    seen = []
    orig = m.decoder.greedy_buffers

    def spy(*a, **k):
        out = orig(*a, **k)
        seen.append(out)
        return out

    m.decoder.greedy_buffers = spy
    try:
        greedy_decode(m, gen_cfg, _enc(1, 3), _prompt(tcfg, 3), 20)
        out = greedy_decode(m, gen_cfg, _enc(2, 3),
                            _prompt(tcfg, 3, (1002, 1003)), 20)
        greedy_decode(m, gen_cfg, _enc(3, 2), _prompt(tcfg, 2), 20)
    finally:
        del m.decoder.greedy_buffers
    assert seen[0][0] is seen[1][0] and seen[0][1] is seen[1][1]
    assert seen[2][0] is not seen[0][0]
    assert all(isinstance(c, W._StepBuffers) and x is c.cross
               for c, x in seen)
    assert len(m.decoder._step_pools) == 2
    assert len(fresh.decoder._step_pools) == 0     # a copy starts with none
    ref = greedy_decode(fresh, gen_cfg, _enc(2, 3),
                        _prompt(tcfg, 3, (1002, 1003)), 20)
    for a, r in zip(out, ref):
        if r is not None:
            assert torch.equal(a, r)


def _eager_call(case, dec, ids, cache, cross):
    """One single-token ``decoder_cached`` call on the pooled buffers, or on
    a fresh copy of them, that has to take the eager step."""
    if case == "fresh_cache":
        # the beam's standalone permute: a new cache dict every step
        return dec.decoder_cached(ids, 3, {k: c.clone() for k, c in
                                           cache.items()}, cross)
    if case == "foreign_cross":
        # the pooled cache with a cross-KV that is not its own
        return dec.decoder_cached(ids, 3, cache, [
            tuple(t.clone() for t in c) for c in cross])
    if case == "alignment_slots":
        h, _ = dec.decoder_cached(
            ids, 3, cache, cross,
            alignment_slots=torch.ones(len(dec.layers), 1, 2))
        return h
    if case == "grad":
        with torch.enable_grad():
            return dec.decoder_cached(ids, 3, cache, cross)
    # two tokens at once
    return dec.decoder_cached(ids.repeat(1, 2), 3, cache, cross)[:, -1:]


@pytest.mark.parametrize("case", ["fresh_cache", "foreign_cross",
                                  "alignment_slots", "grad", "two_tokens"])
def test_other_calls_take_the_eager_step(model, case):
    """A fresh cache dict (the beam's standalone permute), the pooled cache
    with another cross-KV than its own, ``alignment_slots``, autograd or
    more than one token: the eager body runs, and no graph replay is
    counted."""
    _, _, tcfg, m = model
    dec = m.decoder
    cache, cross = dec.greedy_buffers(_enc(4, 3), 3, 8, False)
    ids = torch.full((3, 1), 1000)
    steps = _Calls(dec, "decoder_step")
    try:
        with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]):
            t0 = time.time_ns()
            dec.decoder_cached(_prompt(tcfg, 3), 0, cache, cross)
            _eager_call(case, dec, ids, cache, cross)
            counts = obs.counts_between(t0, time.time_ns())
    finally:
        steps.restore()
    assert steps.n == 0
    assert counts.get("greedy.graph_replays", 0) == 0


@pytest.mark.parametrize("eos", ["suppressed", "early"])
def test_wrapped_calls_per_decode(model, eos):
    """The benchmark's interposition: per ``greedy_decode``,
    ``decoder_cached`` (wrapped on the instance) is called steps + 1 times
    and ``lm_logits`` steps + 2 times, and each ``lm_logits`` return is the
    logits of its position, as the eager teacher-forced decoder gives them
    over the decode's own tokens."""
    _, _, tcfg, m = model
    dec = m.decoder
    kw = ({"suppress_tokens": (tcfg.eos_token_id,)} if eos == "suppressed"
          else {"return_timestamps": False, "eos_token_id": 1270})
    gen_cfg = _gen_cfg(tcfg, **kw)
    rng = np.random.default_rng(0)
    rng.standard_normal((3, 300, 128))
    enc = torch.from_numpy((rng.standard_normal((3, 300, 128))
                            * 2.0).astype(np.float32))
    prompt = _prompt(tcfg, 3)
    steps_in = _Calls(dec, "decoder_cached")
    logits = _Calls(dec, "lm_logits", keep=True)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            t0 = time.time_ns()
            out = greedy_decode(m, gen_cfg, enc, prompt, 20)
            counts = obs.counts_between(t0, time.time_ns())
    finally:
        steps_in.restore()
        logits.restore()
    steps = counts["greedy.steps"]
    assert (steps == 20) == (eos == "suppressed")
    assert steps_in.n == steps + 1 and logits.n == steps + 2
    with torch.no_grad():
        hidden = dec(out.sequences[:, :3 + steps], enc)
        ref = dec.lm_logits(hidden)
    got = torch.stack([logits.returns[0]] + logits.returns[2:], dim=1)
    assert _rel(got, ref[:, 2:3 + steps]) <= 1e-5
    assert _rel(logits.returns[1], ref[:, 0]) <= 1e-5
