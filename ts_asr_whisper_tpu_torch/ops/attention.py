"""Attention core of the port: the dispatching ``sdpa`` and the encoder's
flash attention, forward and backward.

Counterpart of ts_asr_whisper_tpu/ops/attention.py. Long unmasked
self-attention (the encoder: no mask, q_len == kv_len >= 256) goes to
``flash_mha``: ``FlashMHA`` where a gradient can flow, an autograd function
whose forward is ``flash_mha_fwd`` (which then also writes the row
log-sum-exp) and whose backward is ``flash_mha_bwd``, else
``flash_mha_fwd`` alone. Each launches its hand-written CUDA
kernel (kernels/csrc/flash_attn_fwd.cu, flash_attn_bwd.cu) for CUDA tensors
and runs its plain PyTorch version (``flash_mha_reference``,
``flash_mha_bwd_reference``) only for CPU tensors. Everything else (the
decoder's masked self-attention, its cross-attention) is plain
``matmul``/``softmax`` under autograd, as the JAX package leaves it to XLA.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels import DTYPE_CODES, launch_counts, route

F32_MIN = torch.finfo(torch.float32).min
HEAD_DIM = 64  # the kernel's only head dim: every Whisper size has it


def resolve_attention_impl(impl: str, device: torch.device) -> str:
    """``model.attention_impl`` -> 'flash' | 'plain' for the encoder.

    'auto' and 'pallas' take the flash kernels, forward and backward, for
    decoding and for training alike. The JAX package's 'auto' picks XLA for
    training (models/containers.py:40-51); the port does not copy that
    choice: on the card every encoder layer runs the kernels. 'xla' is the
    plain path, and only on the CPU. 'xla_bf16' (bf16 scores) is a TPU knob
    that is not ported."""
    if impl in ("auto", "pallas"):
        return "flash"
    if impl == "xla" and torch.device(device).type == "cpu":
        return "plain"
    raise NotImplementedError(
        f"model.attention_impl={impl!r} is not ported to {device}: use "
        "'auto' or 'pallas'")


def flash_mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        with_lse: bool = False):
    """Plain PyTorch version of the kernel, same math: fp32 scores and
    softmax with max subtraction, ``p`` cast to v's dtype before ``p.v``,
    division by the fp32 row sum at the end. (B, H, T, hd), q pre-scaled.
    With ``with_lse`` also the row log-sum-exp ``m + log(sum p)`` (fp32,
    (B, H, T)), which the backward takes instead of recomputing it."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    denom = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    out = (o / denom).to(q.dtype)
    if with_lse:
        return out, (m + torch.log(denom)).squeeze(-1)
    return out


def flash_mha_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  with_lse: bool = False):
    """(B, H, T, hd) -> (B, H, T, hd); q pre-scaled, no mask (encoder).
    With ``with_lse``, ``(out, lse)``: lse (B, H, T) fp32 is written only
    when asked for."""
    if route(q, "flash_mha_fwd") == "plain":
        return flash_mha_reference(q, k, v, with_lse)
    from ..kernels import flash_attn_fwd_lib

    lib = flash_attn_fwd_lib()
    _check_kernel_args("flash_mha_fwd", q, k=k, v=v)
    b, h, t, d = q.shape
    q, k, v = (x.contiguous() for x in (q, k, v))
    out = torch.empty_like(q)
    lse = (torch.empty(b, h, t, dtype=torch.float32, device=q.device)
           if with_lse else None)
    err = lib.flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b * h, t, d,
        DTYPE_CODES[q.dtype], q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed: CUDA error {err}")
    launch_counts["flash_attn_fwd"] += 1
    return (out, lse) if with_lse else out


def flash_mha_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, out: torch.Tensor,
                            lse: torch.Tensor, g: torch.Tensor):
    """Plain PyTorch version of the backward kernel, not autograd: the TPU
    kernel's math (attention.py:113-174) from the forward's saved output
    and row log-sum-exp. fp32 scores, p = exp(s - lse), dp = g v^T in fp32,
    D = rowsum(g * out) in fp32 (the TPU kernel's rowsum(dp * p), since
    out = p v, up to the rounding of out to its dtype),
    ds = p * (dp - D); ds and p rounded to q's dtype before dq = ds k,
    dk = ds^T q and dv = p^T g (fp32 accumulation), each cast to its
    input's dtype. (B, H, T, hd) each, lse (B, H, T), q pre-scaled; g is
    d(out)."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    p = torch.exp(scores - lse.float().unsqueeze(-1))
    dp = torch.matmul(g.float(), v.float().transpose(-1, -2))
    big_d = (g.float() * out.float()).sum(dim=-1, keepdim=True)
    ds = p * (dp - big_d)
    ds_lo = ds.to(q.dtype).float()
    p_lo = p.to(q.dtype).float()
    dq = torch.matmul(ds_lo, k.float()).to(q.dtype)
    dk = torch.matmul(ds_lo.transpose(-1, -2), q.float()).to(k.dtype)
    dv = torch.matmul(p_lo.transpose(-1, -2), g.float()).to(v.dtype)
    return dq, dk, dv


def _check_kernel_args(op: str, q: torch.Tensor, **others) -> None:
    for name, x in others.items():
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{op}: {name} {tuple(x.shape)} {x.dtype} "
                             f"{x.device} does not match q {tuple(q.shape)} "
                             f"{q.dtype} {q.device}")
    if q.ndim != 4 or q.shape[-1] != HEAD_DIM:
        raise ValueError(f"{op}: head dim {q.shape[-1]} of shape "
                         f"{tuple(q.shape)} (kernel takes (B, H, T, "
                         f"{HEAD_DIM}))")
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"{op}: dtype {q.dtype} (kernel takes float32 and "
                         "bfloat16)")


def flash_mha_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  out: torch.Tensor, lse: torch.Tensor, g: torch.Tensor):
    """(dq, dk, dv) of ``flash_mha_fwd`` for the output gradient ``g``,
    from the forward's ``out`` and ``lse``; (B, H, T, hd) each, in q's
    dtype."""
    if route(q, "flash_mha_bwd") == "plain":
        return flash_mha_bwd_reference(q, k, v, out, lse, g)
    from ..kernels import flash_attn_bwd_lib

    lib = flash_attn_bwd_lib()
    _check_kernel_args("flash_mha_bwd", q, k=k, v=v, out=out, g=g)
    b, h, t, d = q.shape
    if (lse.shape != (b, h, t) or lse.dtype != torch.float32
            or lse.device != q.device):
        raise ValueError(f"flash_mha_bwd: lse {tuple(lse.shape)} "
                         f"{lse.dtype} {lse.device}, want ({b}, {h}, {t}) "
                         "float32")
    q, k, v, out, lse, g = (x.contiguous() for x in (q, k, v, out, lse, g))
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    # D = rowsum(g * out) per q row; for bf16 also the fp32 dq accumulator
    # that the main kernel adds into
    big_d = torch.empty(b * h, t, dtype=torch.float32, device=q.device)
    dq_acc = (torch.empty(b * h, t, d, dtype=torch.float32, device=q.device)
              if q.dtype == torch.bfloat16 else None)
    err = lib.flash_attn_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        out.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), big_d.data_ptr(),
        None if dq_acc is None else dq_acc.data_ptr(), b * h, t, d,
        DTYPE_CODES[q.dtype], q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_bwd launch failed: CUDA error {err}")
    launch_counts["flash_attn_bwd"] += 1
    return dq, dk, dv


class FlashMHA(torch.autograd.Function):
    """Encoder flash attention with its own backward, as the JAX package's
    ``custom_vjp`` (attention.py:216-229). When an input needs a gradient
    the forward also writes the row log-sum-exp and saves
    (q, k, v, out, lse), so the backward recomputes no row statistics.
    ``flash_mha`` calls it only with grad mode on; under ``torch.no_grad``
    (decoding) the kernel writes no lse and nothing is saved."""

    @staticmethod
    def forward(ctx, q, k, v):
        if not any(ctx.needs_input_grad):
            return flash_mha_fwd(q, k, v)
        out, lse = flash_mha_fwd(q, k, v, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        return flash_mha_bwd(q, k, v, out, lse, g)


def flash_mha(q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """``FlashMHA`` where a gradient can flow, else the forward alone (inside
    an autograd function grad mode is always off, so the choice is made
    here)."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashMHA.apply(q, k, v)
    return flash_mha_fwd(q, k, v)


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
            out = flash_mha(*(x.reshape(-1, *x.shape[-3:])
                              for x in (q, k, v)))
            return out.reshape(*lead, *out.shape[-3:])
        return flash_mha(q, k, v)
    return plain_sdpa(q, k, v, mask)
