"""The flash-attention backward of the port on the CPU: the plain backward
(``flash_mha_bwd_reference``, the kernel's plain version), fed the plain
forward's saved output and row log-sum-exp, against the JAX package's
Pallas backward in interpret mode and against ``jax.vjp`` of its XLA
attention; ``FlashMHA`` takes the plain versions both ways for CPU tensors
and never for a CUDA tensor."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity_utils  # noqa: F401  (caps torch's threads)
from ts_asr_whisper_tpu.ops.attention import _flash_mha_bwd_pallas, _xla_sdpa
from ts_asr_whisper_tpu_torch import kernels
from ts_asr_whisper_tpu_torch.ops import attention as A

# the Pallas backward and the plain one differ only in summation order:
# tests/test_attention.py:63 holds the Pallas kernel at 2e-4
ATOL = RTOL = 2e-4
# against autograd of the XLA attention, whose softmax backward is arranged
# differently
VJP_TOL = 3e-4


def _inputs(seed, t, b=1, h=2):
    rng = np.random.default_rng(seed)
    shape = (b, h, t, 64)
    return tuple(rng.standard_normal(shape).astype(np.float32) * s
                 for s in (0.125, 1.0, 1.0, 1.0))


def _plain_bwd(q, k, v, g):
    """The plain backward from the plain forward's (out, lse), as
    ``FlashMHA`` feeds it."""
    out, lse = A.flash_mha_reference(q, k, v, with_lse=True)
    return A.flash_mha_bwd_reference(q, k, v, out, lse, g)


@pytest.mark.parametrize("t", [256, 300, 512])
def test_plain_backward_matches_the_pallas_backward(t):
    """T = 300 leaves a partial q-block (block_q 256) in the Pallas kernel."""
    q, k, v, g = _inputs(t, t)
    ref = _flash_mha_bwd_pallas(*(jnp.asarray(x) for x in (q, k, v, g)),
                                interpret=True)
    out = _plain_bwd(*(torch.from_numpy(x) for x in (q, k, v, g)))
    for name, o, r in zip("qkv", out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=ATOL,
                                   rtol=RTOL, err_msg=f"d{name}")


@pytest.mark.parametrize("t", [256, 300])
def test_plain_backward_matches_the_vjp_of_xla_attention(t):
    q, k, v, g = _inputs(t + 1, t, b=2)
    _, vjp = jax.vjp(_xla_sdpa, *(jnp.asarray(x) for x in (q, k, v)))
    ref = vjp(jnp.asarray(g))
    out = _plain_bwd(*(torch.from_numpy(x) for x in (q, k, v, g)))
    for name, o, r in zip("qkv", out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=VJP_TOL,
                                   rtol=VJP_TOL, err_msg=f"d{name}")


def test_plain_backward_rounds_as_the_tpu_kernel_in_bf16():
    """bf16 inputs: ds and p are rounded to bf16 before the products and
    each gradient comes back in its input's dtype."""
    q, k, v, g = (torch.from_numpy(x).to(torch.bfloat16)
                  for x in _inputs(3, 300))
    ref = _flash_mha_bwd_pallas(
        *(jnp.asarray(x.float().numpy(), dtype=jnp.bfloat16)
          for x in (q, k, v, g)), interpret=True)
    out = _plain_bwd(q, k, v, g)
    for name, o, r in zip("qkv", out, ref):
        assert o.dtype == torch.bfloat16
        r = np.asarray(r, dtype=np.float32)
        rel = np.linalg.norm(o.float().numpy() - r) / np.linalg.norm(r)
        assert rel < 1e-2, f"d{name}: {rel}"


def test_flash_mha_takes_the_plain_versions_on_the_cpu(monkeypatch):
    calls = []
    fwd, bwd = A.flash_mha_reference, A.flash_mha_bwd_reference
    monkeypatch.setattr(A, "flash_mha_reference",
                        lambda *a, **kw: calls.append("fwd") or fwd(*a, **kw))
    monkeypatch.setattr(A, "flash_mha_bwd_reference",
                        lambda *a: calls.append("bwd") or bwd(*a))
    before = dict(kernels.launch_counts)
    q, k, v, g = _inputs(5, 300)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = A.sdpa(tq, tk, tv, flash=True)
    out.backward(torch.from_numpy(g))
    assert calls == ["fwd", "bwd"]
    assert kernels.launch_counts == before
    out_ref, vjp = jax.vjp(_xla_sdpa, *(jnp.asarray(x) for x in (q, k, v)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref),
                               atol=2e-5, rtol=1e-5)
    for x, r in zip((tq, tk, tv), vjp(jnp.asarray(g))):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(r),
                                   atol=VJP_TOL, rtol=VJP_TOL)


def test_flash_mha_saves_only_q_k_v():
    """The inputs and the forward's own out and lse: no (T, T) intermediate
    and no row statistic to recompute in the backward."""
    q, k, v, _ = _inputs(6, 256)
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = A.FlashMHA.apply(*xs)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 5
    assert all(s is x for s, x in zip(saved, xs))
    want_out, want_lse = A.flash_mha_reference(*xs, with_lse=True)
    torch.testing.assert_close(saved[3], want_out, atol=0, rtol=0)
    assert saved[4].shape == (1, 2, 256) and saved[4].dtype == torch.float32
    torch.testing.assert_close(saved[4], want_lse, atol=0, rtol=0)


def test_no_grad_forward_asks_for_no_lse(monkeypatch):
    """Decoding (``torch.no_grad``) and inputs that need no gradient take
    the forward alone: no lse is written and no autograd node is made."""
    asked = []
    fwd = A.flash_mha_fwd
    monkeypatch.setattr(A, "flash_mha_fwd", lambda *a, **kw: asked.append(
        kw.get("with_lse", False)) or fwd(*a, **kw))
    q, k, v, _ = _inputs(7, 256)
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    with torch.no_grad():
        out = A.sdpa(*xs, flash=True)
    assert out.grad_fn is None
    out = A.sdpa(*(x.detach() for x in xs), flash=True)
    assert out.grad_fn is None
    assert asked == [False, False]
    A.sdpa(*xs, flash=True)
    assert asked == [False, False, True]


def test_flash_mha_under_checkpoint_matches_plain_autograd():
    """The 'full' remat of the fine-tune (non-reentrant
    ``torch.utils.checkpoint``) recomputes the forward, lse included."""
    from torch.utils.checkpoint import checkpoint

    q, k, v, w = _inputs(8, 300)
    grads = []
    for fn in (lambda *x: checkpoint(A.flash_mha, *x, use_reentrant=False),
               A.flash_mha_reference):
        xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        (fn(*xs) * torch.from_numpy(w)).sum().backward()
        grads.append([x.grad for x in xs])
    for a, r in zip(*grads):
        torch.testing.assert_close(a, r, atol=VJP_TOL, rtol=VJP_TOL)


@pytest.mark.parametrize("t", [256, 300])
def test_rowsum_g_out_equals_rowsum_dp_p(t):
    """D from the saved output, rowsum(g * out), is the TPU kernel's
    rowsum(dp * p) (attention.py:139) in fp32, since out = p v."""
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(t + 2, t))
    out = A.flash_mha_reference(q, k, v)
    p = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
    dp = g @ v.transpose(-1, -2)
    torch.testing.assert_close((g * out).sum(-1), (dp * p).sum(-1),
                               atol=1e-5, rtol=0)


def test_cuda_tensor_never_takes_the_plain_backward(monkeypatch):
    cuda_like = types.SimpleNamespace(device=torch.device("cuda", 0))

    def no_build():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(kernels, "flash_attn_bwd_lib", no_build)
    monkeypatch.setattr(A, "flash_mha_bwd_reference",
                        lambda *a: pytest.fail("plain version taken"))
    before = kernels.launch_counts["flash_attn_bwd"]
    with pytest.raises(RuntimeError, match="nvcc"):
        A.flash_mha_bwd(*[cuda_like] * 6)
    assert kernels.launch_counts["flash_attn_bwd"] == before
    with pytest.raises(RuntimeError, match="no implementation"):
        A.flash_mha_bwd(*(torch.zeros(1, 1, 256, 64, device="meta")
                          for _ in range(6)))
