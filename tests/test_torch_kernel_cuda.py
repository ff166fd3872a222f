"""The CUDA kernels of the port against their plain PyTorch versions, on the
card: encoder flash attention forward and backward, beam ancestry attention,
the candidate CTC-psi gather + dot and the two KV-cache reorder kernels.
Skips without a GPU; run there with
``python -m pytest tests/test_torch_kernel_cuda.py -m cuda``."""

import numpy as np
import pytest
import torch

from ts_asr_whisper_tpu_torch.kernels import launch_counts
from ts_asr_whisper_tpu_torch.ops import attention as A
from ts_asr_whisper_tpu_torch.ops import beam_attention as BA
from ts_asr_whisper_tpu_torch.ops import psi_gather as PG
from ts_asr_whisper_tpu_torch.ops import reorder as R

pytestmark = pytest.mark.cuda

# fp32: the kernel's FMA path against fp32 matmuls (no TF32), as
# tests/test_attention.py holds the TPU kernel; bf16: rounding of p and of
# the output to bf16 dominates
TOLS = {torch.float32: (2e-5, 1e-5), torch.bfloat16: (1e-2, 1e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(shape, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(shape).astype(np.float32) * 0.125
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    return tuple(torch.from_numpy(x).to(device=device, dtype=dtype)
                 for x in (q, k, v))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [256, 257, 1000, 1499, 1500])
def test_kernel_matches_plain(cuda, dtype, t):
    q, k, v = _qkv((2, 3, t, 64), dtype, cuda, seed=t)
    before = A.launch_counts["flash_attn_fwd"]
    out = A.flash_mha_fwd(q, k, v)
    torch.cuda.synchronize()
    assert A.launch_counts["flash_attn_fwd"] == before + 1
    ref = A.flash_mha_reference(q, k, v)
    atol, rtol = TOLS[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)


def test_kernel_rejects_other_head_dims(cuda):
    q, k, v = _qkv((1, 2, 300, 32), torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="head dim"):
        A.flash_mha_fwd(q, k, v)


def test_sdpa_dispatches_encoder_attention_to_the_kernel(cuda):
    q, k, v = _qkv((1, 2, 2, 300, 64), torch.bfloat16, cuda)
    before = A.launch_counts["flash_attn_fwd"]
    out = A.sdpa(q, k, v, flash=True)
    assert A.launch_counts["flash_attn_fwd"] == before + 1
    ref = A.flash_mha_reference(q, k, v)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [256, 257, 300, 1499, 1500])
def test_backward_kernel_matches_plain(cuda, dtype, t):
    q, k, v = _qkv((2, 3, t, 64), dtype, cuda, seed=t)
    g = _qkv((2, 3, t, 64), dtype, cuda, seed=t + 1)[1]
    before = launch_counts["flash_attn_bwd"]
    out = A.flash_mha_bwd(q, k, v, g)
    torch.cuda.synchronize()
    assert launch_counts["flash_attn_bwd"] == before + 1
    ref = A.flash_mha_bwd_reference(q, k, v, g)
    for o, r in zip(out, ref):
        assert o.dtype == dtype
        if dtype == torch.float32:  # as tests/test_attention.py:63
            torch.testing.assert_close(o, r, atol=2e-4, rtol=2e-4)
        else:  # the bf16 rounding of ds and p dominates
            rel = (o.float() - r.float()).norm() / r.float().norm()
            assert rel <= 1e-2


def test_backward_kernel_rejects_other_head_dims(cuda):
    q, k, v = _qkv((1, 2, 300, 32), torch.bfloat16, cuda)
    before = launch_counts["flash_attn_bwd"]
    with pytest.raises(ValueError, match="head dim"):
        A.flash_mha_bwd(q, k, v, q)
    half = [x.half() for x in _qkv((1, 2, 300, 64), torch.float32, cuda)]
    with pytest.raises(ValueError, match="dtype"):
        A.flash_mha_bwd(*half, half[0])
    assert launch_counts["flash_attn_bwd"] == before


def test_flash_mha_autograd_runs_both_kernels(cuda):
    """FlashMHA through sdpa: the forward and backward kernels, one launch
    each, gradients as autograd through the plain forward (fp32)."""
    q, k, v = _qkv((2, 2, 300, 64), torch.float32, cuda, seed=9)
    w = torch.randn(q.shape, device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(0))
    before = dict(launch_counts)
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    (A.sdpa(*xs, flash=True) * w).sum().backward()
    assert launch_counts["flash_attn_fwd"] == before["flash_attn_fwd"] + 1
    assert launch_counts["flash_attn_bwd"] == before["flash_attn_bwd"] + 1
    refs = [x.clone().requires_grad_() for x in (q, k, v)]
    (A.flash_mha_reference(*refs) * w).sum().backward()
    for x, r in zip(xs, refs):
        torch.testing.assert_close(x.grad, r.grad, atol=2e-4, rtol=2e-4)


def _ancestry_inputs(bb, n, h, t, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((bb, h, 1, 64)).astype(np.float32) * 0.125
    kn, vn = (rng.standard_normal((bb, h, 1, 64)).astype(np.float32)
              for _ in range(2))
    ck, cv = (rng.standard_normal((bb, h, t, 64)).astype(np.float32)
              for _ in range(2))
    hist = rng.integers(0, n, size=(bb, t)).astype(np.int32)
    out = [torch.from_numpy(x).to(device=device, dtype=dtype)
           for x in (q, kn, vn, ck, cv)]
    return out + [torch.from_numpy(hist).to(device)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,pos", [(128, 1), (128, 64), (128, 127),
                                   (448, 1), (448, 224), (448, 447)])
def test_ancestry_kernel_matches_plain(cuda, dtype, t, pos):
    args = _ancestry_inputs(10, 5, 20, t, dtype, cuda, seed=t + pos)
    before = launch_counts["ancestry_attn"]
    out = BA.ancestry_attention(*args, pos=pos, n=5)
    torch.cuda.synchronize()
    assert launch_counts["ancestry_attn"] == before + 1
    ref = BA.ancestry_attention_reference(*args, pos=pos, n=5)
    assert out.dtype == dtype
    atol, rtol = TOLS[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)


def _psi_inputs(device, p_dtype, b_audio=2, v=51866, t=375, bb=10, k=512,
                seed=0):
    rng = np.random.default_rng(seed)
    p = rng.random((b_audio, v, t), dtype=np.float32)
    p /= p.sum(axis=1, keepdims=True)
    ids = np.sort(rng.choice(v, size=(bb, k)), axis=1).astype(np.int32)
    w = rng.random((bb, t), dtype=np.float32)
    w[:, :50] = 0.0
    audio_idx = (np.arange(bb) // (bb // b_audio)).astype(np.int32)
    p_vt = PG.padded_posterior(torch.from_numpy(p).to(device), p_dtype)
    return (p_vt, torch.from_numpy(audio_idx).to(device),
            torch.from_numpy(ids).to(device), torch.from_numpy(w).to(device))


@pytest.mark.parametrize("p_dtype", [torch.float32, torch.bfloat16])
def test_psi_kernel_matches_plain(cuda, p_dtype):
    p_vt, audio_idx, ids, w = _psi_inputs(cuda, p_dtype)
    before = launch_counts["psi_gather_dot"]
    out = PG.psi_gather_dot(p_vt, audio_idx, ids, w)
    torch.cuda.synchronize()
    assert launch_counts["psi_gather_dot"] == before + 1
    ref = PG.psi_gather_dot_reference(p_vt, audio_idx, ids, w)
    # fp32 sums of ~375 products in another order
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("p_dtype", [torch.float32, torch.bfloat16])
def test_psi_kernel_rejects_unaligned_rows(cuda, p_dtype):
    p_vt, audio_idx, ids, w = _psi_inputs(cuda, p_dtype)
    before = launch_counts["psi_gather_dot"]
    with pytest.raises(ValueError, match="16-byte"):  # T=375 unpadded
        PG.psi_gather_dot(p_vt.contiguous(), audio_idx, ids, w)
    assert launch_counts["psi_gather_dot"] == before


def test_psi_kernel_flags_out_of_range_ids(cuda):
    p_vt, audio_idx, ids, w = _psi_inputs(cuda, torch.float32, v=1000,
                                          bb=2, k=16)
    ids[0, 3] = 1000
    out = PG.psi_gather_dot(p_vt, audio_idx, ids, w)
    assert torch.isnan(out[0, 3]) and torch.isfinite(out[1]).all()


def _reorder_idx(kind, bb, n=5, seed=0):
    """Source rows of one beam step: drawn with repeats within each group of
    n, the identity, or each group reversed."""
    base = np.arange(bb) // n * n
    if kind == "repeats":
        rng = np.random.default_rng(seed)
        return (base + rng.integers(0, 2, size=bb)).astype(np.int32)
    if kind == "identity":
        return np.arange(bb, dtype=np.int32)
    return (base + (n - 1 - np.arange(bb) % n)).astype(np.int32)


def _reorder_cache(layout, bb, t, dtype, device, seed=0):
    shape = (4, bb, 20, t, 64) if layout == "bhtd" else (4, t, bb, 20, 64)
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, device=device, generator=gen).to(dtype)


@pytest.mark.parametrize("kind", ["repeats", "identity", "reversal"])
@pytest.mark.parametrize("bb,t", [(10, 128), (15, 128), (10, 448)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["bhtd", "tbhd"])
def test_reorder_kernel_matches_plain(cuda, layout, dtype, bb, t, kind):
    cache = _reorder_cache(layout, bb, t, dtype, cuda, seed=bb + t)
    idx = torch.from_numpy(_reorder_idx(kind, bb, seed=t)).to(cuda)
    fn, ref_fn = {"bhtd": (R.reorder_bhtd, R.reorder_bhtd_reference),
                  "tbhd": (R.reorder_tbhd, R.reorder_tbhd_reference)}[layout]
    name = f"kv_reorder_{layout}"
    before = launch_counts[name]
    out = fn(cache, idx)
    torch.cuda.synchronize()
    assert launch_counts[name] == before + 1
    assert out.dtype == dtype and out.data_ptr() != cache.data_ptr()
    assert torch.equal(out, ref_fn(cache, idx))  # a copy: bit for bit


@pytest.mark.parametrize("layout", ["bhtd", "tbhd"])
def test_reorder_kernel_flags_out_of_range_rows(cuda, layout):
    cache = _reorder_cache(layout, 10, 16, torch.bfloat16, cuda)
    idx = torch.arange(10, device=cuda, dtype=torch.int32)
    idx[3] = 10
    out = (R.reorder_bhtd if layout == "bhtd" else R.reorder_tbhd)(cache, idx)
    hyp = 1 if layout == "bhtd" else 2
    assert torch.isnan(out.select(hyp, 3)).all()
    keep = [b for b in range(10) if b != 3]
    assert torch.equal(out.index_select(hyp, torch.tensor(keep, device=cuda)),
                       cache.index_select(hyp, torch.tensor(keep,
                                                            device=cuda)))


def test_reorder_kernel_rejects_unaligned_slabs(cuda):
    cache = torch.zeros(2, 4, 4, 3, 2, dtype=torch.bfloat16, device=cuda)
    idx = torch.zeros(4, dtype=torch.int32, device=cuda)
    before = dict(launch_counts)
    with pytest.raises(ValueError, match="16-byte"):
        R.reorder_tbhd(cache, idx)  # 3 x 2 bf16 = 12-byte slabs
    with pytest.raises(ValueError, match="idx"):
        R.reorder_bhtd(cache, idx[:3])
    assert launch_counts == before


@pytest.mark.parametrize("layout,kernel", [("bhtd", "kv_reorder_bhtd"),
                                           ("tbhd", "kv_reorder_tbhd"),
                                           ("thbd", None)])
def test_beam_reorder_pallas_reaches_the_kernel(cuda, layout, kernel):
    """'pallas' on the card launches the layout's kernel ('thbd' has none
    and takes the one-hot product, as on the TPU)."""
    bb, n = 10, 5
    shape = {"bhtd": (2, bb, 20, 8, 64), "tbhd": (2, 8, bb, 20, 64),
             "thbd": (2, 8, 20, bb, 64)}[layout]
    cache = torch.randn(shape, device=cuda).to(torch.bfloat16)
    idx = torch.from_numpy(_reorder_idx("repeats", bb)).to(cuda)
    chosen = (idx.long() - torch.arange(bb, device=cuda) // n * n).view(-1, n)
    prev = R.get_reorder_impl(raw=True)
    before = dict(launch_counts)
    try:
        R.set_reorder_impl("pallas")
        out = R.beam_reorder(cache, chosen, n, idx, layout)
    finally:
        R.set_reorder_impl(prev)
    hyp = {"bhtd": 1, "tbhd": 2, "thbd": 3}[layout]
    assert torch.equal(out, cache.index_select(hyp, idx.long()))
    for name in ("kv_reorder_bhtd", "kv_reorder_tbhd"):
        assert launch_counts[name] == before[name] + (name == kernel)
