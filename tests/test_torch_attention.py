"""The port's attention core on the CPU: the flash kernel's plain version
against the TPU kernel (``_flash_mha_fwd`` in interpret mode) and the XLA
path, the ``sdpa`` dispatch, and the rule that a CUDA tensor never takes the
plain version."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity_utils  # noqa: F401  (caps torch's threads)
from ts_asr_whisper_tpu.ops.attention import _flash_mha_fwd, _xla_sdpa
from ts_asr_whisper_tpu_torch import kernels
from ts_asr_whisper_tpu_torch.ops import attention as A

ATOL, RTOL = 2e-5, 1e-5  # as tests/test_attention.py


def _qkv(rng, t, b=1, h=2, d=64):
    q = rng.standard_normal((b, h, t, d)).astype(np.float32) * 0.2
    k = rng.standard_normal((b, h, t, d)).astype(np.float32) * 0.2
    v = rng.standard_normal((b, h, t, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("t", [256, 300, 1500])
def test_reference_matches_tpu_kernel_and_xla(rng, t):
    q, k, v = _qkv(rng, t)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    tpu = np.asarray(_flash_mha_fwd(jq, jk, jv, interpret=True))
    xla = np.asarray(_xla_sdpa(jq, jk, jv))
    before = A.launch_counts["flash_attn_fwd"]
    out = A.flash_mha_fwd(*(torch.from_numpy(x) for x in (q, k, v))).numpy()
    np.testing.assert_allclose(out, tpu, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(out, xla, atol=ATOL, rtol=RTOL)
    assert A.launch_counts["flash_attn_fwd"] == before  # CPU: no launch


@pytest.mark.parametrize("t", [256, 300, 1500])
def test_reference_lse_is_logsumexp_of_the_jax_scores(rng, t):
    """The row log-sum-exp that the forward saves for the backward:
    logsumexp of the JAX package's fp32 scores on the same inputs."""
    q, k, v = _qkv(rng, t)
    scores = jnp.einsum("bhqd,bhkd->bhqk", jnp.asarray(q), jnp.asarray(k),
                        preferred_element_type=jnp.float32)
    want = np.asarray(jax.nn.logsumexp(scores, axis=-1))
    out, lse = A.flash_mha_fwd(*(torch.from_numpy(x) for x in (q, k, v)),
                               with_lse=True)
    assert lse.shape == (1, 2, t) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), want, atol=1e-5, rtol=0)
    torch.testing.assert_close(out, A.flash_mha_reference(
        *(torch.from_numpy(x) for x in (q, k, v))), atol=0, rtol=0)


def test_reference_rounds_p_to_v_dtype(rng):
    """bf16 inputs: p is cast to bf16 before p.v, as the TPU kernel does."""
    q, k, v = (torch.from_numpy(x).bfloat16() for x in _qkv(rng, 256))
    out = A.flash_mha_reference(q, k, v)
    assert out.dtype == torch.bfloat16
    s = q.float() @ k.float().transpose(-1, -2)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    want = (p.bfloat16().float() @ v.float()) / p.sum(-1, keepdim=True)
    torch.testing.assert_close(out, want.bfloat16(), atol=0, rtol=0)


def test_sdpa_dispatch_condition(rng, monkeypatch):
    calls = []
    monkeypatch.setattr(A, "flash_mha_fwd",
                        lambda q, k, v: calls.append(q.shape) or q)
    x = torch.zeros(1, 2, 256, 64)
    A.sdpa(x, x, x, flash=True)                            # taken
    A.sdpa(torch.zeros(1, 2, 3, 2, 256, 64),
           torch.zeros(1, 2, 3, 2, 256, 64),
           torch.zeros(1, 2, 3, 2, 256, 64), flash=True)   # leading dims
    A.sdpa(x, x, x, flash=False)                           # impl off
    A.sdpa(x[..., :255, :], x[..., :255, :], x[..., :255, :], flash=True)
    A.sdpa(x[..., :4, :], x, x, flash=True)                # q_len != kv_len
    A.sdpa(x, x, x, mask=torch.ones(256, 256, dtype=torch.bool), flash=True)
    assert calls == [(1, 2, 256, 64), (6, 2, 256, 64)]


@pytest.mark.parametrize("t", [256, 300])
def test_sdpa_plain_path_matches_xla(rng, t):
    q, k, v = _qkv(rng, t)
    ref = np.asarray(_xla_sdpa(*(jnp.asarray(x) for x in (q, k, v))))
    out = A.sdpa(*(torch.from_numpy(x) for x in (q, k, v))).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


def test_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    cuda_like = types.SimpleNamespace(device=torch.device("cuda", 0))
    assert kernels.route(cuda_like, "op") == "kernel"
    assert kernels.route(torch.zeros(1), "op") == "plain"
    with pytest.raises(RuntimeError, match="no implementation"):
        kernels.route(torch.zeros(1, device="meta"), "op")

    def no_build():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(kernels, "flash_attn_fwd_lib", no_build)
    monkeypatch.setattr(A, "flash_mha_reference",
                        lambda *a, **kw: pytest.fail("plain version taken"))
    before = A.launch_counts["flash_attn_fwd"]
    with pytest.raises(RuntimeError, match="nvcc"):
        A.flash_mha_fwd(cuda_like, cuda_like, cuda_like)
    assert A.launch_counts["flash_attn_fwd"] == before


def test_attention_impl_resolution():
    assert A.resolve_attention_impl("auto", torch.device("cuda")) == "flash"
    assert A.resolve_attention_impl("pallas", torch.device("cuda")) == "flash"
    assert A.resolve_attention_impl("xla", torch.device("cpu")) == "plain"
    for impl in ("xla", "xla_bf16"):
        with pytest.raises(NotImplementedError):
            A.resolve_attention_impl(impl, torch.device("cuda"))


def test_kernel_build_without_nvcc_raises(tmp_path, monkeypatch):
    """Without nvcc the build raises instead of falling back."""
    monkeypatch.setattr(kernels, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(kernels.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    if (kernels.Path("/usr/local/cuda") / "bin" / "nvcc").exists():
        pytest.skip("a CUDA toolkit is installed here")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build("flash_attn_fwd")
