"""Port ``beam_search`` under every KV-cache reorder impl and every cache
layout it takes, against the JAX package's ``beam_search`` under the same
switches (ops/reorder.py ``set_reorder_impl``, models/whisper.py
``set_kv_cache_layout``) on the same weights, with and without joint CTC:
tokens and lengths exact, scores within 2e-5 (tests/test_beam.py:83-134).
On the CPU the JAX package's 'pallas' is its one-hot product and its
'ancestry_pallas' kernel runs in interpret mode; the port's 'pallas' is the
plain gather of the reorder kernels and 'ancestry*' the plain ancestry
attention."""

import jax.numpy as jnp
import pytest
import torch

from test_torch_beam import MAX_NEW, _compare, _gen_cfg, _scorers, _setup
from torch_parity_utils import make_pair
from ts_asr_whisper_tpu.decoding.beam import beam_search as jax_beam
from ts_asr_whisper_tpu.models import whisper as JW
from ts_asr_whisper_tpu.ops import reorder as JR
from ts_asr_whisper_tpu_torch.decoding import beam as B
from ts_asr_whisper_tpu_torch.kernels import launch_counts
from ts_asr_whisper_tpu_torch.models import whisper as TW
from ts_asr_whisper_tpu_torch.ops import reorder as TR

N = 3
CASES = [(impl, layout)
         for impl in ("onehot", "pallas", "fused", "fused_onehot")
         for layout in ("bhtd", "tbhd", "thbd")] \
    + [("ancestry", "bhtd"), ("ancestry_pallas", "bhtd")]


@pytest.fixture
def switches():
    """Set both packages' reorder impl and cache layout; restore them (and
    drop the JAX trace, which does not key on the switches) afterwards."""
    saved = (JR.get_reorder_impl(raw=True), JW.get_kv_cache_layout(),
             TR.get_reorder_impl(raw=True), TW.get_kv_cache_layout())

    def set_both(impl, layout):
        JR.set_reorder_impl(impl)
        JW.set_kv_cache_layout(layout)
        TR.set_reorder_impl(impl)
        TW.set_kv_cache_layout(layout)
        jax_beam.clear_cache()

    yield set_both
    JR.set_reorder_impl(saved[0])
    JW.set_kv_cache_layout(saved[1])
    TR.set_reorder_impl(saved[2])
    TW.set_kv_cache_layout(saved[3])
    jax_beam.clear_cache()


@pytest.mark.parametrize("ctc", [False, True], ids=["no_ctc", "joint_ctc"])
@pytest.mark.parametrize("impl,layout", CASES,
                         ids=[f"{i}-{lay}" for i, lay in CASES])
def test_beam_reorder_impl_parity(rng, switches, impl, layout, ctc):
    jcfg, params, model, enc, prompt = _setup(rng)
    gen_cfg = _gen_cfg(jcfg)
    jargs, targs = {}, {}
    if ctc:
        (js, jst), (ts, tst) = _scorers(jcfg, params, enc, N,
                                        gen_cfg.timestamp_begin)
        jargs = dict(ctc_scorer=js, ctc_state=jst)
        targs = dict(ctc_scorer=ts, ctc_state=tst)
    switches(impl, layout)
    ref = jax_beam(params, jcfg, gen_cfg, jnp.asarray(enc),
                   jnp.asarray(prompt), MAX_NEW, num_beams=N, **jargs)
    before = dict(launch_counts)
    out = B.beam_search(model, gen_cfg, torch.from_numpy(enc),
                        torch.from_numpy(prompt), MAX_NEW, N, **targs)
    _compare(out, ref)
    assert launch_counts == before  # CPU tensors: no kernel launches
    assert (out.sequences[:, 3:] < gen_cfg.timestamp_begin).any()


def test_ancestry_needs_the_bhtd_layout(rng, switches):
    jcfg, _, model, enc, prompt = _setup(rng)
    switches("ancestry", "tbhd")
    with pytest.raises(AssertionError, match="bhtd"):
        B.beam_search(model, _gen_cfg(jcfg), torch.from_numpy(enc),
                      torch.from_numpy(prompt), MAX_NEW, N)


@pytest.mark.parametrize("layout", ["bhtd", "tbhd", "thbd"])
def test_kv_cache_layout_shapes(switches, layout):
    switches("auto", layout)
    model = make_pair()[3]
    cache = model.decoder.init_kv_cache(6, 9, torch.device("cpu"))
    want = {"bhtd": (2, 6, 2, 9, 64), "tbhd": (2, 9, 6, 2, 64),
            "thbd": (2, 9, 2, 6, 64)}[layout]
    assert cache["k"].shape == cache["v"].shape == want
    assert not cache["k"].any()
