"""The flash-attention backward of the port on the CPU: the plain backward
(``flash_mha_bwd_reference``, the kernel's plain version) against the JAX
package's Pallas backward in interpret mode and against ``jax.vjp`` of its
XLA attention; ``FlashMHA`` takes the plain versions both ways for CPU
tensors and never for a CUDA tensor."""

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


@pytest.mark.parametrize("t", [256, 300, 512])
def test_plain_backward_matches_the_pallas_backward(t):
    """T = 300 leaves a partial q-block (block_q 256) in the Pallas kernel."""
    q, k, v, g = _inputs(t, t)
    ref = _flash_mha_bwd_pallas(*(jnp.asarray(x) for x in (q, k, v, g)),
                                interpret=True)
    out = A.flash_mha_bwd_reference(*(torch.from_numpy(x)
                                      for x in (q, k, v, g)))
    for name, o, r in zip("qkv", out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=ATOL,
                                   rtol=RTOL, err_msg=f"d{name}")


@pytest.mark.parametrize("t", [256, 300])
def test_plain_backward_matches_the_vjp_of_xla_attention(t):
    q, k, v, g = _inputs(t + 1, t, b=2)
    _, vjp = jax.vjp(_xla_sdpa, *(jnp.asarray(x) for x in (q, k, v)))
    ref = vjp(jnp.asarray(g))
    out = A.flash_mha_bwd_reference(*(torch.from_numpy(x)
                                      for x in (q, k, v, g)))
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
    out = A.flash_mha_bwd_reference(q, k, v, g)
    for name, o, r in zip("qkv", out, ref):
        assert o.dtype == torch.bfloat16
        r = np.asarray(r, dtype=np.float32)
        rel = np.linalg.norm(o.float().numpy() - r) / np.linalg.norm(r)
        assert rel < 1e-2, f"d{name}: {rel}"


def test_flash_mha_takes_the_plain_versions_on_the_cpu(monkeypatch):
    calls = []
    fwd, bwd = A.flash_mha_reference, A.flash_mha_bwd_reference
    monkeypatch.setattr(A, "flash_mha_reference",
                        lambda *a: calls.append("fwd") or fwd(*a))
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
    q, k, v, _ = _inputs(6, 256)
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = A.FlashMHA.apply(*xs)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 3
    assert all(s is x for s, x in zip(saved, xs))


def test_cuda_tensor_never_takes_the_plain_backward(monkeypatch):
    cuda_like = types.SimpleNamespace(device=torch.device("cuda", 0))

    def no_build():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(kernels, "flash_attn_bwd_lib", no_build)
    monkeypatch.setattr(A, "flash_mha_bwd_reference",
                        lambda *a: pytest.fail("plain version taken"))
    before = kernels.launch_counts["flash_attn_bwd"]
    with pytest.raises(RuntimeError, match="nvcc"):
        A.flash_mha_bwd(cuda_like, cuda_like, cuda_like, cuda_like)
    assert kernels.launch_counts["flash_attn_bwd"] == before
    with pytest.raises(RuntimeError, match="no implementation"):
        A.flash_mha_bwd(*(torch.zeros(1, 1, 256, 64, device="meta")
                          for _ in range(4)))
