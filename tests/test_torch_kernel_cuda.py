"""The CUDA flash-attention kernel against its plain PyTorch version, on the
card. Skips without a GPU; run there with
``python -m pytest tests/test_torch_kernel_cuda.py -m cuda``."""

import numpy as np
import pytest
import torch

from ts_asr_whisper_tpu_torch.ops import attention as A

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
