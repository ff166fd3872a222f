"""The CUDA kernels of the port against their plain PyTorch versions, on the
card: encoder flash attention forward and backward (also at the local head
counts of tensor parallelism, on SE-DiCoW's SCB cross-attention over stream
slices, and in an encoder under the 'attn' remat policy),
beam ancestry attention
(on a beam search's own ancestry map, at every class of pos, around the
cluster size, at the longest cache it takes, and one launch captured in a
CUDA graph and replayed at other positions), the candidate CTC-psi gather +
dot (with NaN in the row padding, and captured and replayed on new inputs)
and the two KV-cache reorder kernels. Also the card's side of the plain
decode paths: the int8 cross-attention against the CPU, the thresholded
top-k against the stable sort, and the sampler's reproducibility.
Skips without a GPU; run there with
``python -m pytest tests/test_torch_kernel_cuda.py -m cuda``."""

import numpy as np
import pytest
import torch

from ts_asr_whisper_tpu_torch.kernels import (DTYPE_CODES, ancestry_attn_lib,
                                              launch_counts)
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
@pytest.mark.parametrize("t", [128, 257, 1000, 1499, 1500])
def test_kernel_lse_matches_plain(cuda, dtype, t):
    """The row log-sum-exp the forward writes for the backward; the output
    is the same with and without it."""
    q, k, v = _qkv((2, 3, t, 64), dtype, cuda, seed=t + 7)
    out, lse = A.flash_mha_fwd(q, k, v, with_lse=True)
    torch.cuda.synchronize()
    ref_out, ref_lse = A.flash_mha_reference(q, k, v, with_lse=True)
    assert lse.shape == (2, 3, t) and lse.dtype == torch.float32
    # fp32 scores of bf16 products are exact in both; only the summation
    # order of the row sum differs
    torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(out, A.flash_mha_fwd(q, k, v), atol=0, rtol=0)
    atol, rtol = TOLS[dtype]
    torch.testing.assert_close(out.float(), ref_out.float(), atol=atol,
                               rtol=rtol)


def _bwd_inputs(t, dtype, device):
    """q, k, v, g and the kernel forward's (out, lse), fed alike to the
    kernel and to the plain backward."""
    q, k, v = _qkv((2, 3, t, 64), dtype, device, seed=t)
    g = _qkv((2, 3, t, 64), dtype, device, seed=t + 1)[1]
    out, lse = A.flash_mha_fwd(q, k, v, with_lse=True)
    return q, k, v, out, lse, g


def _assert_bwd_close(out, ref, dtype):
    for o, r in zip(out, ref):
        assert o.dtype == dtype
        if dtype == torch.float32:  # as tests/test_attention.py:63
            torch.testing.assert_close(o, r, atol=2e-4, rtol=2e-4)
        else:  # the bf16 rounding of ds and p dominates
            rel = (o.float() - r.float()).norm() / r.float().norm()
            assert rel <= 1e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [128, 256, 257, 300, 1499, 1500])
def test_backward_kernel_matches_plain(cuda, dtype, t):
    args = _bwd_inputs(t, dtype, cuda)
    before = launch_counts["flash_attn_bwd"]
    out = A.flash_mha_bwd(*args)
    torch.cuda.synchronize()
    assert launch_counts["flash_attn_bwd"] == before + 1
    _assert_bwd_close(out, A.flash_mha_bwd_reference(*args), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", [10, 5])
def test_kernels_at_tensor_parallel_local_heads(cuda, dtype, heads):
    """The forward (out, lse) and the backward at the turbo fine-tune's
    micro-batch of 4 with the 20 heads split over a model axis of 2 or 4
    (parallel/tensor.py): B·H of 40 and 20 rows of blocks."""
    shape = (4, heads, 1500, 64)
    q, k, v = _qkv(shape, dtype, cuda, seed=heads)
    g = _qkv(shape, dtype, cuda, seed=heads + 1)[1]
    before = (launch_counts["flash_attn_fwd"], launch_counts["flash_attn_bwd"])
    out, lse = A.flash_mha_fwd(q, k, v, with_lse=True)
    grads = A.flash_mha_bwd(q, k, v, out, lse, g)
    torch.cuda.synchronize()
    assert (launch_counts["flash_attn_fwd"], launch_counts["flash_attn_bwd"]) \
        == (before[0] + 1, before[1] + 1)
    ref_out, ref_lse = A.flash_mha_reference(q, k, v, with_lse=True)
    atol, rtol = TOLS[dtype]
    torch.testing.assert_close(out.float(), ref_out.float(), atol=atol,
                               rtol=rtol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=1e-5)
    _assert_bwd_close(grads, A.flash_mha_bwd_reference(q, k, v, out, lse, g),
                      dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernel_calls_agree(cuda, dtype):
    """dq's fp32 sums arrive in a varying order (bf16: added into the
    accumulator by the card's bulk reduce), so two calls agree within the
    tolerance, not bit for bit; dk and dv carry no such sum."""
    args = _bwd_inputs(1500, dtype, cuda)
    first = A.flash_mha_bwd(*args)
    second = A.flash_mha_bwd(*args)
    _assert_bwd_close(second, first, dtype)
    assert torch.equal(first[1], second[1]) and torch.equal(first[2],
                                                             second[2])


def test_backward_kernel_rejects_other_head_dims(cuda):
    q, k, v = _qkv((1, 2, 300, 32), torch.bfloat16, cuda)
    lse = torch.zeros(1, 2, 300, device=cuda)
    before = launch_counts["flash_attn_bwd"]
    with pytest.raises(ValueError, match="head dim"):
        A.flash_mha_bwd(q, k, v, q, lse, q)
    half = [x.half() for x in _qkv((1, 2, 300, 64), torch.float32, cuda)]
    with pytest.raises(ValueError, match="dtype"):
        A.flash_mha_bwd(*half, half[0], lse, half[0])
    bf = _qkv((1, 2, 300, 64), torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="lse"):
        A.flash_mha_bwd(*bf, bf[0], lse.bfloat16(), bf[0])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scb_cross_attention_backward_on_stream_slices(cuda, dtype):
    """SE-DiCoW's SCB: q from stream 0, k and v from stream 1 of (B, 2, T,
    D), head-split views that are not contiguous. The kernels' dq lands in
    the sample stream and dk / dv in the enrollment stream, as the plain
    forward's autograd puts them; one forward and one backward launch."""
    from ts_asr_whisper_tpu_torch.models.whisper import split_heads

    rng = np.random.default_rng(11)
    x0 = torch.from_numpy(rng.standard_normal((2, 2, 1500, 128)).astype(
        np.float32)).to(device=cuda, dtype=dtype)
    w = torch.from_numpy(rng.standard_normal((2, 2, 1500, 64)).astype(
        np.float32)).to(device=cuda, dtype=dtype)
    grads = []
    for attend in (A.flash_mha, A.flash_mha_reference):
        x = x0.clone().requires_grad_()
        q = split_heads(x[:, 0] * 0.125, 2)
        k, v = split_heads(x[:, 1], 2), split_heads(x[:, 1] * 0.5, 2)
        assert not q.is_contiguous() and not k.is_contiguous()
        before = dict(launch_counts)
        (attend(q, k, v).float() * w.float()).sum().backward()
        torch.cuda.synchronize()
        fwd = launch_counts["flash_attn_fwd"] - before["flash_attn_fwd"]
        bwd = launch_counts["flash_attn_bwd"] - before["flash_attn_bwd"]
        assert (fwd, bwd) == ((1, 1) if attend is A.flash_mha else (0, 0))
        grads.append(x.grad)
    out, ref = grads
    assert out[:, 0].abs().max() > 0 and out[:, 1].abs().max() > 0
    _assert_bwd_close((out[:, 0], out[:, 1]), (ref[:, 0], ref[:, 1]), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attn_remat_replays_no_flash_forward(cuda, dtype):
    """Remat policy 'attn' (models/dicow.py::DiCoWEncoder._remat_layer) on
    the card: a 2-layer DiCoW encoder with FDDTs (d_model 128 over 2 heads,
    T 300) launches one flash forward per layer and pass where 'full'
    launches two, one backward each, and gives the gradients of 'full'
    (fp32 within the kernel backward's tolerance, bf16 within its
    Frobenius bound: dq is summed in run-to-run order)."""
    from ts_asr_whisper_tpu_torch.models.config import DiCoWConfig
    from ts_asr_whisper_tpu_torch.models.dicow import DiCoW

    cfg = DiCoWConfig(
        vocab_size=2000, num_mel_bins=80, d_model=128, encoder_layers=2,
        decoder_layers=1, encoder_attention_heads=2,
        decoder_attention_heads=2, encoder_ffn_dim=256, decoder_ffn_dim=256,
        max_source_positions=300, max_target_positions=64, use_fddt=True,
        fddt_init="random", dtype=dtype)
    torch.manual_seed(0)
    enc = DiCoW(cfg, flash=True).to(cuda).encoder.train()
    rng = np.random.default_rng(13)
    feats = torch.from_numpy(rng.standard_normal((2, 80, 600)).astype(
        np.float32)).to(cuda)
    stno = torch.from_numpy(rng.dirichlet(np.ones(4), (2, 300)).astype(
        np.float32)).transpose(1, 2).contiguous().to(cuda)
    w = torch.from_numpy(rng.standard_normal((2, 300, 128)).astype(
        np.float32)).to(cuda)
    grads, fwd = {}, {}
    for policy in ("full", "attn"):
        enc.remat = policy
        enc.zero_grad(set_to_none=True)
        before = dict(launch_counts)
        (enc(feats, stno).float() * w).sum().backward()
        torch.cuda.synchronize()
        fwd[policy] = launch_counts["flash_attn_fwd"] - before[
            "flash_attn_fwd"]
        assert launch_counts["flash_attn_bwd"] - before["flash_attn_bwd"] \
            == cfg.encoder_layers
        grads[policy] = {n: p.grad for n, p in enc.named_parameters()}
    assert fwd == {"full": 2 * cfg.encoder_layers,
                   "attn": cfg.encoder_layers}
    for n, g in grads["attn"].items():
        r = grads["full"][n]
        if dtype == "float32":  # as tests/test_attention.py:63
            torch.testing.assert_close(g, r, atol=2e-4, rtol=2e-4)
        else:
            assert (g - r).norm() <= 1e-2 * r.norm(), n


def _ancestry_inputs(bb, n, h, t, dtype, device, seed=0, hist=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((bb, h, 1, 64)).astype(np.float32) * 0.125
    kn, vn = (rng.standard_normal((bb, h, 1, 64)).astype(np.float32)
              for _ in range(2))
    ck, cv = (rng.standard_normal((bb, h, t, 64)).astype(np.float32)
              for _ in range(2))
    if hist is None:
        hist = rng.integers(0, n, size=(bb, t)).astype(np.int32)
    out = [torch.from_numpy(x).to(device=device, dtype=dtype)
           for x in (q, kn, vn, ck, cv)]
    return out + [torch.from_numpy(hist).to(device)]


def _check_ancestry(args, pos, n, dtype):
    before = launch_counts["ancestry_attn"]
    out = BA.ancestry_attention(*args, pos=pos, n=n)
    torch.cuda.synchronize()
    assert launch_counts["ancestry_attn"] == before + 1
    ref = BA.ancestry_attention_reference(*args, pos=pos, n=n)
    assert out.dtype == dtype
    atol, rtol = TOLS[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,pos", [(128, 1), (128, 64), (128, 127),
                                   (448, 1), (448, 224), (448, 447)])
def test_ancestry_kernel_matches_plain(cuda, dtype, t, pos):
    args = _ancestry_inputs(10, 5, 20, t, dtype, cuda, seed=t + pos)
    _check_ancestry(args, pos, 5, dtype)


POS_CLASSES = {"0": lambda t: 0, "1": lambda t: min(1, t - 1),
               "mid": lambda t: t // 2, "last": lambda t: t - 1}


@pytest.mark.parametrize("pos_class", sorted(POS_CLASSES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [1, 127, 129, 447, 448])
def test_ancestry_kernel_on_beam_history(cuda, t, dtype, pos_class):
    """A beam search's own ancestry map (beams share prefixes) at cache
    lengths whose T - 1 positions do not divide evenly over the cluster."""
    hist = BA.beam_search_history(np.random.default_rng(t), 2, 5, t)
    args = _ancestry_inputs(10, 5, 20, t, dtype, cuda, seed=t + 1, hist=hist)
    _check_ancestry(args, POS_CLASSES[pos_class](t), 5, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ancestry_kernel_at_batch_three(cuda, dtype):
    hist = BA.beam_search_history(np.random.default_rng(15), 3, 5, 448)
    args = _ancestry_inputs(15, 5, 20, 448, dtype, cuda, seed=15, hist=hist)
    for pos in (0, 5, 300, 447):
        _check_ancestry(args, pos, 5, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ancestry_kernel_around_the_cluster_size(cuda, dtype):
    """Positions fewer than, equal to, one more than and many more than the
    CTAs of a cluster (4 in bf16, 8 in fp32)."""
    hist = BA.beam_search_history(np.random.default_rng(8), 2, 5, 200)
    args = _ancestry_inputs(10, 5, 4, 200, dtype, cuda, seed=8, hist=hist)
    for pos in (0, 3, 4, 5, 8, 9, 199):
        _check_ancestry(args, pos, 5, dtype)


@pytest.mark.parametrize("dtype,t_max", [(torch.float32, 3169),
                                         (torch.bfloat16, 3149)])
def test_ancestry_kernel_takes_the_longest_cache_it_holds(cuda, dtype,
                                                          t_max):
    """The kernel's own limit (a CTA's slice of K and V in shared memory):
    it runs at T = t_max, and one more position raises with the limit."""
    assert ancestry_attn_lib().ancestry_attn_max_len(DTYPE_CODES[dtype]) \
        == t_max
    hist = BA.beam_search_history(np.random.default_rng(3), 2, 5, t_max)
    args = _ancestry_inputs(10, 5, 2, t_max, dtype, cuda, seed=3, hist=hist)
    for pos in (1, t_max - 1):
        _check_ancestry(args, pos, 5, dtype)
    args = _ancestry_inputs(10, 5, 2, t_max + 1, dtype, cuda, seed=3)
    before = launch_counts["ancestry_attn"]
    with pytest.raises(ValueError, match=f"T={t_max + 1} > {t_max}"):
        BA.ancestry_attention(*args, pos=5, n=5)
    assert launch_counts["ancestry_attn"] == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ancestry_kernel_replays_at_device_positions(cuda, dtype):
    """One launch captured in a CUDA graph with pos in a device int32 gives
    the plain version's output at three other positions on replay."""
    hist = BA.beam_search_history(np.random.default_rng(7), 2, 5, 448)
    args = _ancestry_inputs(10, 5, 20, 448, dtype, cuda, seed=7, hist=hist)
    pos = torch.tensor([100], dtype=torch.int32, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up outside the capture
        BA.ancestry_attention(*args, pos=pos, n=5)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = BA.ancestry_attention(*args, pos=pos, n=5)
    atol, rtol = TOLS[dtype]
    for p in (3, 224, 447):
        pos.fill_(p)
        graph.replay()
        torch.cuda.synchronize()
        ref = BA.ancestry_attention_reference(*args, pos=p, n=5)
        torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                                   rtol=rtol)


def test_ancestry_kernel_rejects_what_it_cannot_take(cuda):
    args = _ancestry_inputs(10, 5, 2, 16, torch.bfloat16, cuda)
    before = launch_counts["ancestry_attn"]
    with pytest.raises(ValueError, match="pos"):
        BA.ancestry_attention(*args, pos=16, n=5)
    with pytest.raises(ValueError, match="pos tensor"):
        BA.ancestry_attention(*args, pos=torch.tensor([3], device=cuda), n=5)
    with pytest.raises(ValueError, match="dtypes"):
        BA.ancestry_attention(*args[:3], args[3].float(), *args[4:], pos=3,
                              n=5)
    with pytest.raises(ValueError, match="n 3"):
        BA.ancestry_attention(*args, pos=3, n=3)
    assert launch_counts["ancestry_attn"] == before


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
@pytest.mark.parametrize("t", [375, 376, 1500])
@pytest.mark.parametrize("k", [500, 513])
def test_psi_kernel_at_other_shapes(cuda, k, t, p_dtype):
    """Slot counts that leave a warp's rows partly empty, rows that fill
    their stride (T 376) or take several passes (T 1500)."""
    p_vt, audio_idx, ids, w = _psi_inputs(cuda, p_dtype, v=4000, t=t, k=k,
                                          seed=k + t)
    out = PG.psi_gather_dot(p_vt, audio_idx, ids, w)
    torch.cuda.synchronize()
    ref = PG.psi_gather_dot_reference(p_vt, audio_idx, ids, w)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("p_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [369, 375])
def test_psi_kernel_ignores_the_row_padding(cuda, t, p_dtype):
    """The kernel reads a row's last 16-byte vector whole, padding included:
    NaN there (a posterior in a buffer that is not zero-filled) must not
    reach the sums. T 369 leaves 7 padding elements, 375 one."""
    p_vt, audio_idx, ids, w = _psi_inputs(cuda, p_dtype, v=4000, t=t)
    ld = -(-t // PG.ROW_ALIGN) * PG.ROW_ALIGN
    full = torch.full((*p_vt.shape[:2], ld), float("nan"), dtype=p_dtype,
                      device=cuda)
    full[..., :t] = p_vt
    nan_padded = full[..., :t]
    out = PG.psi_gather_dot(nan_padded, audio_idx, ids, w)
    torch.cuda.synchronize()
    ref = PG.psi_gather_dot_reference(p_vt, audio_idx, ids, w)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)


def test_psi_kernel_replays_on_new_inputs(cuda):
    """A call captured in a CUDA graph reads its inputs on replay: new ids,
    weights and audio rows written in place give the plain version's sums."""
    p_vt, audio_idx, ids, w = _psi_inputs(cuda, torch.float32, v=4000)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up outside the capture
        PG.psi_gather_dot(p_vt, audio_idx, ids, w)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        out = PG.psi_gather_dot(p_vt, audio_idx, ids, w)
    for seed in (1, 2):
        _, a2, i2, w2 = _psi_inputs(cuda, torch.float32, v=4000, seed=seed)
        audio_idx.copy_(a2.flip(0))
        ids.copy_(i2)
        w.copy_(w2)
        graph.replay()
        torch.cuda.synchronize()
        ref = PG.psi_gather_dot_reference(p_vt, audio_idx, ids, w)
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


# ---------------------------------------------------------------- decode
# paths in plain PyTorch (no kernel of their own)


@pytest.mark.parametrize("n", [1, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_cross_attention_on_the_card_matches_the_cpu(cuda, dtype, n):
    """The int8 cross-attention at turbo's head shape (20 heads, 1500
    positions), one query per hypothesis, n beams folded into the query
    axis: the card against the CPU on the same codes and scales."""
    from ts_asr_whisper_tpu_torch.models.whisper import (cross_attention,
                                                         quantize_cross_kv)

    q, k, v = _qkv((2, 20, 1500, 64), torch.float32, "cpu", seed=n)
    q = q[:, :, :1].repeat(n, 1, 1, 1) * 8.0
    cross = quantize_cross_kv([(k.to(dtype), v.to(dtype))])[0]
    ref = cross_attention(q.to(dtype), cross, dtype).float()
    out = cross_attention(q.to(dtype).to(cuda),
                          {key: t.to(cuda) for key, t in cross.items()},
                          dtype)
    torch.cuda.synchronize()
    atol, rtol = TOLS[dtype]
    torch.testing.assert_close(out.float().cpu(), ref, atol=atol, rtol=rtol)


@pytest.mark.parametrize("shape,k", [((2, 5 * 51866), 10), ((8, 4096), 10),
                                     ((16, 2048), 12), ((3, 16), 16)])
def test_thresholded_topk_on_the_card_equals_the_stable_sort(cuda, shape, k):
    from ts_asr_whisper_tpu_torch.ops.topk import topk_lax, topk_thresholded

    gen = torch.Generator(device=cuda).manual_seed(k)
    x = torch.randn(shape, device=cuda, generator=gen)
    x[:, ::7] = x[:, :1]                 # exact ties across the row
    x[0, :] = -1e9                       # a row of equal values
    v, i = topk_thresholded(x, k)
    v_ref, i_ref = topk_lax(x, k)
    assert torch.equal(v, v_ref) and torch.equal(i, i_ref)


def test_sampler_on_the_card_is_reproducible(cuda):
    from ts_asr_whisper_tpu_torch.decoding.greedy import sample

    scores = torch.randn(16, 51866, device=cuda)
    scores[:, ::3] = -torch.inf

    def draw(seed):
        gen = torch.Generator(device=cuda).manual_seed(seed)
        return torch.stack([sample(scores, 0.8, gen) for _ in range(20)])

    a, b, c = draw(3), draw(3), draw(4)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert (a % 3 != 0).all()            # -inf tokens are never drawn
