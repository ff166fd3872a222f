"""Candidate-restricted CTC psi of the port: a fused gather + dot kernel.

Counterpart of ts_asr_whisper_tpu/ops/psi_gather.py (``extract_topk_ids``,
``gather_rows`` with the compact einsum that consumes it, and
``ctc_psi_candidates``). The beam rescorer needs log(psi) only for the ~500
top-by-attention candidates of each hypothesis, so instead of the full-vocab
matmul it computes, per candidate row of the vocab-major posterior,

    vals[b, j] = sum_t P[audio_idx[b], ids[b, j], t] * w[b, t]

in fp32 (``psi_gather_dot``). On a CUDA tensor that is the hand-written
kernel kernels/csrc/psi_gather_dot.cu, which reads each candidate's T-row
once and keeps nothing but the (Bb, K) sums; ``w`` stays fp32 for a bf16
posterior, as in the JAX package's matmul path (its gather path rounds ``w``
to bf16 first, psi_gather.py:175); its plain PyTorch version,
``psi_gather_dot_reference``, runs only for CPU tensors. The TPU module's
time fold of the posterior (``fold_posterior`` / ``fold_weights``, a rule
of TPU DMA tiling) has no counterpart: the kernel reads the unfolded rows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import DTYPE_CODES, launch_counts, raw_stream, route
from .ctc_prefix import LOG_ZERO, psi_match_scores, psi_weights

ROW_ALIGN = 8  # elements: a padded row stride keeps rows 16-byte aligned


def padded_posterior(p_vt: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(B, V, T) posterior in ``dtype`` whose rows start 16-byte aligned:
    stored with its row stride padded to a multiple of 8 elements (zeros),
    returned as the (B, V, T) view, so the kernel reads whole 16-byte
    vectors. At T=375 a row is 1,500 bytes in fp32 and 750 in bf16."""
    t = p_vt.shape[-1]
    tp = -(-t // ROW_ALIGN) * ROW_ALIGN
    return F.pad(p_vt.to(dtype), (0, tp - t))[..., :t]


def extract_topk_ids(mask: torch.Tensor, k_pad: int) -> torch.Tensor:
    """ids[b, j] = index of the (j+1)-th set bit of mask[b], ascending,
    clamped to V-1 for j >= popcount (pad slots duplicate a real row; the
    duplicate scatter writes carry identical values). The JAX package uses
    a two-level cumulative-count search; a search over the row's running
    count gives the same ids."""
    bb, v = mask.shape
    counts = torch.cumsum(mask.to(torch.int32), dim=1)
    targets = torch.arange(1, k_pad + 1, dtype=counts.dtype,
                           device=mask.device).expand(bb, k_pad)
    ids = torch.searchsorted(counts, targets.contiguous())
    return torch.clamp(ids, max=v - 1).to(torch.int32)


def psi_gather_dot_reference(p_vt: torch.Tensor, audio_idx: torch.Tensor,
                             ids: torch.Tensor, w: torch.Tensor
                             ) -> torch.Tensor:
    """Plain PyTorch version of the kernel, same math: gather the candidate
    T-rows, fp32 products and sums."""
    rows = p_vt[audio_idx.long()[:, None], ids.long()]       # (Bb, K, T)
    return torch.einsum("bkt,bt->bk", rows.float(), w.float())


def psi_gather_dot(p_vt: torch.Tensor, audio_idx: torch.Tensor,
                   ids: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B_audio, V, T) posterior (fp32 or bf16, unit stride along T), (Bb,)
    audio rows, (Bb, K) candidate ids in [0, V), (Bb, T) fp32 weights ->
    (Bb, K) fp32 sums; ``w`` stays fp32 for a bf16 posterior. On the card
    the posterior's rows must start 16-byte aligned, with a row stride of a
    multiple of 8 elements, as ``padded_posterior`` stores them (the kernel
    reads the padding after T whole and ignores it); int32 ids and audio
    rows and a contiguous fp32 ``w`` reach the kernel without a copy."""
    if route(p_vt, "psi_gather_dot") == "plain":
        return psi_gather_dot_reference(p_vt, audio_idx, ids, w)
    from ..kernels import psi_gather_dot_lib

    b_audio, v, t = p_vt.shape
    bb, k = ids.shape
    if p_vt.dtype not in DTYPE_CODES:
        raise ValueError(f"psi_gather_dot: posterior dtype {p_vt.dtype} "
                         "(kernel takes float32 and bfloat16)")
    ld = p_vt.stride(1)
    if p_vt.stride(2) != 1 or ld < t or p_vt.stride(0) != v * ld:
        raise ValueError(f"psi_gather_dot: posterior strides "
                         f"{p_vt.stride()} are not (V*ld, ld, 1)")
    # rows 16-byte aligned, the last 16-byte vector inside the row stride
    if ld % ROW_ALIGN or p_vt.data_ptr() % 16:
        raise ValueError(f"psi_gather_dot: posterior rows are not 16-byte "
                         f"aligned (row stride {ld}); build it with "
                         "padded_posterior")
    if audio_idx.shape != (bb,) or w.shape != (bb, t):
        raise ValueError(f"psi_gather_dot: audio_idx {tuple(audio_idx.shape)}"
                         f" / w {tuple(w.shape)} do not match ids "
                         f"{tuple(ids.shape)} and T={t}")
    dev = p_vt.device
    if not audio_idx.device == ids.device == w.device == dev:
        raise ValueError(f"psi_gather_dot: audio_idx / ids / w on "
                         f"{audio_idx.device} {ids.device} {w.device}, "
                         f"posterior on {dev}")
    if ids.dtype != torch.int32 or not ids.is_contiguous():
        ids = ids.to(torch.int32).contiguous()
    if audio_idx.dtype != torch.int32 or not audio_idx.is_contiguous():
        audio_idx = audio_idx.to(torch.int32).contiguous()
    if w.dtype != torch.float32 or not w.is_contiguous():
        w = w.float().contiguous()
    out = torch.empty(bb, k, dtype=torch.float32, device=dev)
    err = psi_gather_dot_lib().psi_gather_dot(
        p_vt.data_ptr(), ids.data_ptr(), audio_idx.data_ptr(), w.data_ptr(),
        out.data_ptr(), bb, k, v, t, ld, b_audio, DTYPE_CODES[p_vt.dtype],
        dev.index or 0, raw_stream(dev))
    if err != 0:
        raise RuntimeError(f"psi_gather_dot launch failed: CUDA error {err}")
    launch_counts["psi_gather_dot"] += 1
    return out


def ctc_psi_candidates(
    p_vt: torch.Tensor,         # (B_audio, V, T) posterior (fp32 or bf16)
    cand_mask: torch.Tensor,    # (Bb, V_dec) candidate membership
    audio_idx: torch.Tensor,    # (Bb,)
    x_last: torch.Tensor,       # (Bb, T) log-probs of each hyp's last label
    r_prev: torch.Tensor,       # (Bb, T, 2)
    decoded_len: torch.Tensor,  # (Bb,)
    last_label: torch.Tensor,   # (Bb,)
    eos: int,
    k_pad: int,
) -> torch.Tensor:
    """log(psi) scattered over (Bb, V_dec): candidate columns carry the
    closed form, everything else LOG_ZERO; the same tensor as
    ``where(cand_mask, ctc_psi_matmul(...)[:, :V_dec], LOG_ZERO)``, with
    eos taking the full-prefix probability (psi_gather.py:149-187)."""
    bb, v_dec = cand_mask.shape
    ids = extract_topk_ids(cand_mask, k_pad)                 # (Bb, K)
    w, m, r_sum = psi_weights(r_prev, decoded_len)
    vals = psi_gather_dot(p_vt, audio_idx, ids, w)
    psi_c = torch.log(torch.clamp(vals, min=1e-38)) + m[:, None]

    # last-label candidates may only extend blank-ending paths
    psi_match = psi_match_scores(r_prev, x_last, decoded_len)
    is_match = (ids == last_label[:, None]) & (decoded_len > 0)[:, None]
    psi_c = torch.where(is_match, psi_match[:, None], psi_c)

    tmp = torch.full((bb, v_dec), LOG_ZERO, dtype=torch.float32,
                     device=psi_c.device)
    tmp.scatter_(1, ids.long(), psi_c)
    tmp = torch.where(cand_mask, tmp, LOG_ZERO)
    tmp[:, eos] = r_sum[:, -1]
    return tmp
