"""Attention core of the port: the dispatching ``sdpa`` and the encoder's
flash-attention forward.

Counterpart of ts_asr_whisper_tpu/ops/attention.py. Long unmasked
self-attention (the encoder: no mask, q_len == kv_len >= 256) goes to
``flash_mha_fwd``, which launches the hand-written CUDA kernel
(kernels/csrc/flash_attn_fwd.cu) for CUDA tensors and runs its plain PyTorch
version, ``flash_mha_reference``, only for CPU tensors. Everything else (the
decoder's masked self-attention, its cross-attention) is plain
``matmul``/``softmax``, as the JAX package leaves it to XLA.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels import DTYPE_CODES, launch_counts, route

F32_MIN = torch.finfo(torch.float32).min
HEAD_DIM = 64  # the kernel's only head dim: every Whisper size has it


def resolve_attention_impl(impl: str, device: torch.device) -> str:
    """``model.attention_impl`` -> 'flash' | 'plain' for the encoder.

    'auto' and 'pallas' take the flash kernel (the port only decodes, which is
    when the JAX package's 'auto' picks Pallas). 'xla' is the plain path, and
    only on the CPU: on the card every encoder layer runs the kernel.
    'xla_bf16' (bf16 scores) is a TPU knob that is not ported."""
    if impl in ("auto", "pallas"):
        return "flash"
    if impl == "xla" and torch.device(device).type == "cpu":
        return "plain"
    raise NotImplementedError(
        f"model.attention_impl={impl!r} is not ported to {device}: use "
        "'auto' or 'pallas'")


def flash_mha_reference(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel, same math: fp32 scores and
    softmax with max subtraction, ``p`` cast to v's dtype before ``p.v``,
    division by the fp32 row sum at the end. (B, H, T, hd), q pre-scaled."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    denom = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    return (o / denom).to(q.dtype)


def flash_mha_fwd(q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """(B, H, T, hd) -> (B, H, T, hd); q pre-scaled, no mask (encoder)."""
    if route(q, "flash_mha_fwd") == "plain":
        return flash_mha_reference(q, k, v)
    from ..kernels import flash_attn_fwd_lib

    lib = flash_attn_fwd_lib()
    b, h, t, d = q.shape
    for name, x in (("k", k), ("v", v)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"flash_mha_fwd: {name} {tuple(x.shape)} "
                             f"{x.dtype} {x.device} does not match q "
                             f"{tuple(q.shape)} {q.dtype} {q.device}")
    if d != HEAD_DIM:
        raise ValueError(f"flash_mha_fwd: head dim {d} (kernel takes "
                         f"{HEAD_DIM})")
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"flash_mha_fwd: dtype {q.dtype} (kernel takes "
                         "float32 and bfloat16)")
    q, k, v = (x.contiguous() for x in (q, k, v))
    out = torch.empty_like(q)
    err = lib.flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, t,
        d, DTYPE_CODES[q.dtype], q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed: CUDA error {err}")
    launch_counts["flash_attn_fwd"] += 1
    return out


def plain_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scores in fp32 (bf16 products are exact in fp32, as the JAX einsum's
    fp32 accumulation), masked with finfo(float32).min, softmax in fp32,
    probabilities cast to q's dtype before ``p.v``."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if mask is not None:
        scores = scores.masked_fill(~mask, F32_MIN)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(probs, v.to(q.dtype))


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask: Optional[torch.Tensor] = None,
         flash: bool = False) -> torch.Tensor:
    """Dispatching attention core (q pre-scaled). With ``flash``, the JAX
    package's Pallas condition holds: no mask, 4-D or more, q_len == kv_len
    >= 256; extra leading dims flatten into the kernel's batch axis."""
    if (flash and mask is None and q.ndim >= 4
            and q.shape[-2] == k.shape[-2] and q.shape[-2] >= 256):
        if q.ndim > 4:
            lead = q.shape[:-3]
            out = flash_mha_fwd(*(x.reshape(-1, *x.shape[-3:])
                                  for x in (q, k, v)))
            return out.reshape(*lead, *out.shape[-3:])
        return flash_mha_fwd(q, k, v)
    return plain_sdpa(q, k, v, mask)
