"""The greedy step's CUDA graph on the card, at large-v3-turbo's decoder
widths (d 1280, 4 layers, 20 heads, 1500 encoder frames, vocabulary 51866)
in bf16, at the benchmark's buckets 16, 8 and 4: the replay against the
same static step run uncaptured (``WhisperDecoder.decoder_step``), bit for
bit over 125 steps; ``greedy_decode`` with the graph against the same loop
with the step uncaptured; one capture per key; parameters changed in place
reach the replay, and moved ones are captured again. Skips without a GPU;
run there with ``python -m pytest tests/test_torch_greedy_graph_cuda.py -m
cuda``."""

import time
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ts_asr_whisper_tpu_torch.decoding.generation_config import \
    GenerationConfig
from ts_asr_whisper_tpu_torch.decoding.greedy import greedy_decode
from ts_asr_whisper_tpu_torch.models.config import DiCoWConfig
from ts_asr_whisper_tpu_torch.models.whisper import WhisperDecoder
from ts_asr_whisper_tpu_torch.utils import observability as obs

pytestmark = pytest.mark.cuda

T_ENC, PROMPT, NEW = 1500, 3, 125
TOKENS = dict(eos_token_id=50352, pad_token_id=50352, bos_token_id=50352,
              decoder_start_token_id=50353)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def dec(cuda):
    cfg = DiCoWConfig(vocab_size=51866, d_model=1280, decoder_layers=4,
                      decoder_attention_heads=20, decoder_ffn_dim=5120,
                      max_target_positions=448, dtype="bfloat16", **TOKENS)
    torch.manual_seed(0)
    d = WhisperDecoder(cfg)
    with torch.no_grad():
        d.embed_tokens.weight.mul_(0.05)
    return d.to(cuda, torch.bfloat16).eval()


def _inputs(cuda, b, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    enc = torch.randn(b, T_ENC, 1280, generator=g, device=cuda)
    ids = torch.randint(0, 50000, (b, PROMPT + NEW), generator=g,
                        device=cuda)
    ids[:, 0] = TOKENS["decoder_start_token_id"]
    return enc, ids


def _gen_cfg():
    # end of text suppressed: every decode runs all its steps
    return GenerationConfig(max_length=PROMPT + NEW, return_timestamps=True,
                            suppress_tokens=(TOKENS["eos_token_id"],),
                            no_timestamps_token_id=50364, **TOKENS)


def _uncaptured(dec, bufs_cache, bufs_cross):
    """A copy of pooled buffers, a plain cache dict, for the step run as it
    is."""
    cache = {k: c.clone() for k, c in bufs_cache.items()}
    cross = [tuple(t.clone() for t in c) for c in bufs_cross]
    return cache, cross


@pytest.mark.parametrize("b", [16, 8, 4])
@torch.no_grad()
def test_replay_matches_uncaptured_step(dec, cuda, b):
    enc, ids = _inputs(cuda, b, seed=b)
    cache, cross = dec.greedy_buffers(enc, b, PROMPT + NEW, False)
    dec.decoder_cached(ids[:, :PROMPT], 0, cache, cross)
    ref_cache, ref_cross = _uncaptured(dec, cache, cross)
    pos_t = torch.zeros(1, dtype=torch.long, device=cuda)
    for pos in range(PROMPT, PROMPT + NEW):
        h = dec.decoder_cached(ids[:, pos:pos + 1], pos, cache, cross)
        pos_t.fill_(pos)
        ref = dec.decoder_step(ids[:, pos:pos + 1].contiguous(), pos_t,
                               ref_cache, ref_cross)
        assert torch.equal(h, ref), pos
    assert cache.graph is not None and cache.cross is cross
    for k in ("k", "v"):
        assert torch.equal(cache[k], ref_cache[k])


@pytest.mark.parametrize("b", [16, 8, 4])
def test_greedy_with_graph_matches_uncaptured(dec, cuda, b, monkeypatch):
    enc, ids = _inputs(cuda, b, seed=100 + b)
    model = SimpleNamespace(decoder=dec)
    out = greedy_decode(model, _gen_cfg(), enc, ids[:, :PROMPT], NEW)
    assert next(iter(dec._step_pools.values())).graph is not None

    def uncaptured(bufs, input_ids, pos):
        bufs.ids.copy_(input_ids)
        bufs.pos.fill_(pos)
        return dec.decoder_step(bufs.ids, bufs.pos, bufs, bufs.cross)

    monkeypatch.setattr(dec, "_buffered_step", uncaptured)
    ref = greedy_decode(model, _gen_cfg(), enc, ids[:, :PROMPT], NEW)
    assert int(out.lengths.min()) == PROMPT + NEW
    for a, r in zip(out, ref):
        if r is not None:
            assert torch.equal(a, r)


def test_one_capture_per_key(dec, cuda):
    model = SimpleNamespace(decoder=dec)
    with profile(activities=[ProfilerActivity.CPU]):
        t0 = time.time_ns()
        for b in (16, 8, 16):
            enc, ids = _inputs(cuda, b, seed=200 + b)
            greedy_decode(model, _gen_cfg(), enc, ids[:, :PROMPT], NEW)
        torch.cuda.synchronize()
        counts = obs.counts_between(t0, time.time_ns())
    assert counts["greedy.graph_captures"] == 2 == len(dec._step_pools)
    assert counts["greedy.graph_replays"] == counts["greedy.steps"] == 3 * NEW


@torch.no_grad()
def test_replay_reads_the_parameters(dec, cuda):
    """A parameter changed in place reaches the next replay without a new
    capture; parameters moved by a cast are captured again at the next
    decode's buffers."""
    b, pos = 8, PROMPT
    enc, ids = _inputs(cuda, b, seed=300)
    cache, cross = dec.greedy_buffers(enc, b, PROMPT + NEW, False)
    dec.decoder_cached(ids[:, :PROMPT], 0, cache, cross)
    tok = ids[:, pos:pos + 1]
    before = dec.decoder_cached(tok, pos, cache, cross).clone()
    bufs = cache
    graph = bufs.graph
    dec.layers[1].fc2.weight.mul_(0.5)
    dec.layer_norm.bias.add_(0.25)
    after = dec.decoder_cached(tok, pos, cache, cross).clone()
    assert bufs.graph is graph
    ref = dec.decoder_step(tok.contiguous(), bufs.pos, *_uncaptured(
        dec, cache, cross))
    assert torch.equal(after, ref) and not torch.equal(after, before)

    dec.to(torch.float32)       # the compute dtype stays bf16
    cache, cross = dec.greedy_buffers(enc, b, PROMPT + NEW, False)
    assert cache is bufs and bufs.graph is None and len(dec._step_pools) == 1
    dec.decoder_cached(ids[:, :PROMPT], 0, cache, cross)
    moved = dec.decoder_cached(tok, pos, cache, cross).clone()
    assert bufs.graph is not None and bufs.graph is not graph
    ref = dec.decoder_step(tok.contiguous(), bufs.pos, *_uncaptured(
        dec, cache, cross))
    assert torch.equal(moved, ref)
