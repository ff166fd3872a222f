"""The port's KV-cache reorder (ops/reorder.py) against the JAX package's:
the plain versions of the two CUDA kernels bit-exact against the Pallas
kernels run in interpret mode, with repeated source rows; the one-hot
product and the in-place permutes of 'fused' / 'fused_onehot' in all three
layouts; and the reorder switch's 'auto', explicit and raw dispatch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity_utils  # noqa: F401  (caps torch's threads)
from ts_asr_whisper_tpu.ops import reorder as JR
from ts_asr_whisper_tpu_torch.kernels import launch_counts
from ts_asr_whisper_tpu_torch.ops import reorder as TR

N, B = 3, 2                        # beams per audio row, audio rows
BB = N * B
# per output row: a repeated source, a row from the other group's ancestor
# and a row kept in place (beam search picks the same ancestor often)
IDX = np.array([1, 1, 0, 5, 3, 3], np.int32)
CHOSEN = (IDX.reshape(B, N) - np.arange(B)[:, None] * N).astype(np.int32)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SHAPES = {"bhtd": (2, BB, 2, 5, 4), "tbhd": (2, 5, BB, 2, 4),
          "thbd": (2, 5, 2, BB, 4)}


def _cache(layout, dtype):
    """The same cache on both sides: values that bf16 holds exactly."""
    x = np.random.default_rng(0).standard_normal(SHAPES[layout])
    x = np.round(x * 64) / 64
    jdt, tdt = DTYPES[dtype]
    return (jnp.asarray(x, jdt),
            torch.from_numpy(x.astype(np.float32)).to(tdt))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("layout", ["bhtd", "tbhd"])
def test_plain_reorder_equals_interpreted_pallas(layout, dtype):
    jc, tc = _cache(layout, dtype)
    if layout == "bhtd":
        ref = JR._reorder_pallas(jnp.asarray(IDX), jc, interpret=True)
        out = TR.reorder_bhtd(tc, torch.from_numpy(IDX))
    else:
        ref = JR._reorder_pallas_tbhd(jnp.asarray(IDX), jc, interpret=True)
        out = TR.reorder_tbhd(tc, torch.from_numpy(IDX))
    assert out.dtype == tc.dtype and out.shape == tc.shape
    np.testing.assert_array_equal(_np(out),
                                  np.asarray(ref.astype(jnp.float32)))
    # out of place: the input cache is untouched
    np.testing.assert_array_equal(_np(tc), np.asarray(jc.astype(jnp.float32)))


@pytest.mark.parametrize("impl", ["onehot", "fused", "fused_onehot"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("layout", sorted(SHAPES))
def test_onehot_reorder_matches_jax_and_the_gather(layout, dtype, impl):
    """The one-hot product against the JAX package's and the row gather;
    'fused' and 'fused_onehot' through ``beam_reorder``, which must permute
    the cache in place to the same rows."""
    jc, tc = _cache(layout, dtype)
    ref = JR._reorder_onehot(jnp.asarray(CHOSEN), jc, N, layout)
    dim = {"bhtd": 1, "tbhd": 2, "thbd": 3}[layout]
    gather = _np(tc.index_select(dim, torch.from_numpy(IDX).long()))
    if impl == "onehot":
        out = TR._reorder_onehot(torch.from_numpy(CHOSEN), tc, N, layout)
    else:
        prev = TR.get_reorder_impl(raw=True)
        TR.set_reorder_impl(impl)
        try:
            out = TR.beam_reorder(tc, torch.from_numpy(CHOSEN), N,
                                  torch.from_numpy(IDX), layout)
        finally:
            TR.set_reorder_impl(prev)
        assert out is tc
    assert out.dtype == tc.dtype
    np.testing.assert_array_equal(_np(out),
                                  np.asarray(ref.astype(jnp.float32)))
    # exact: one nonzero per output row, the same rows as the gather
    np.testing.assert_array_equal(_np(out), gather)


def test_impl_values_match_the_jax_package():
    prev = JR.get_reorder_impl(raw=True)
    try:
        for impl in TR.IMPLS:
            JR.set_reorder_impl(impl)  # every port value is a JAX value
        for bad in ("gather", "PALLAS", ""):
            with pytest.raises(AssertionError):
                JR.set_reorder_impl(bad)
            with pytest.raises(AssertionError):
                TR.set_reorder_impl(bad)
    finally:
        JR.set_reorder_impl(prev)
    assert set(TR.IMPLS) == {"auto", "onehot", "pallas", "fused",
                             "fused_onehot", "ancestry", "ancestry_pallas"}


def test_auto_resolves_by_device_and_raw_round_trips():
    prev = TR.get_reorder_impl(raw=True)
    try:
        TR.set_reorder_impl("auto")
        assert TR.get_reorder_impl(device=torch.device("cpu")) == "pallas"
        assert TR.get_reorder_impl(device="cuda") == "ancestry_pallas"
        assert TR.get_reorder_impl(raw=True) == "auto"
        # the JAX package resolves 'auto' to 'pallas' off the TPU, as the
        # port does off the card
        assert JR.get_reorder_impl() == "pallas"
        saved = TR.get_reorder_impl(raw=True)
        TR.set_reorder_impl("fused")
        assert TR.get_reorder_impl(device="cuda") == "fused"
        assert TR.get_reorder_impl(raw=True) == "fused"
        TR.set_reorder_impl(saved)
        assert TR.get_reorder_impl(raw=True) == "auto"
    finally:
        TR.set_reorder_impl(prev)


@pytest.mark.parametrize("layout,want", [("bhtd", "bhtd"), ("tbhd", "tbhd"),
                                         ("thbd", "onehot")])
def test_auto_and_explicit_take_the_same_path(monkeypatch, layout, want):
    """'auto' and the impl it resolves to reach the same function of
    ``beam_reorder``; 'pallas' reaches the kernel wrapper of its layout
    ('thbd' has none and takes the one-hot), 'onehot' the product."""
    calls = []
    monkeypatch.setattr(TR, "reorder_bhtd",
                        lambda c, i: calls.append("bhtd") or c)
    monkeypatch.setattr(TR, "reorder_tbhd",
                        lambda c, i: calls.append("tbhd") or c)
    monkeypatch.setattr(TR, "_reorder_onehot",
                        lambda *a, **k: calls.append("onehot") or a[1])
    _, tc = _cache(layout, "float32")
    args = (tc, torch.from_numpy(CHOSEN), N, torch.from_numpy(IDX), layout)
    prev = TR.get_reorder_impl(raw=True)
    try:
        seen = {}
        for impl in ("auto", "pallas", "onehot"):
            TR.set_reorder_impl(impl)
            calls.clear()
            TR.beam_reorder(*args)
            seen[impl] = calls[0]
    finally:
        TR.set_reorder_impl(prev)
    assert seen["auto"] == seen["pallas"] == want
    assert seen["onehot"] == "onehot"


def test_cpu_reorder_launches_no_kernel():
    before = dict(launch_counts)
    for layout, fn in (("bhtd", TR.reorder_bhtd), ("tbhd", TR.reorder_tbhd)):
        _, tc = _cache(layout, "bfloat16")
        fn(tc, torch.from_numpy(IDX))
    assert launch_counts == before
    assert {"kv_reorder_bhtd", "kv_reorder_tbhd"} <= set(launch_counts)
