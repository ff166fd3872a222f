"""The CUDA kernels of the port against their plain PyTorch versions, on the
card: encoder flash attention forward and backward, beam ancestry attention
and the candidate CTC-psi gather + dot. Skips without a GPU; run there with
``python -m pytest tests/test_torch_kernel_cuda.py -m cuda``."""

import numpy as np
import pytest
import torch

from ts_asr_whisper_tpu_torch.kernels import launch_counts
from ts_asr_whisper_tpu_torch.ops import attention as A
from ts_asr_whisper_tpu_torch.ops import beam_attention as BA
from ts_asr_whisper_tpu_torch.ops import psi_gather as PG

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
