"""Beam-search decoder self-attention over an append-only KV cache.

Counterpart of ts_asr_whisper_tpu/ops/beam_attention.py::ancestry_attention.
Beam search never permutes the cache: row b writes its new K/V at (b, pos)
forever, and ``hist[b, t]`` names the row of b's beam group (group-local, in
[0, n)) that holds the K/V of b's hypothesis at position t. One new token per
hypothesis attends to

  - t < pos: K/V of cache row ``(b // n) * n + hist[b, t]``;
  - t == pos: this step's k_new / v_new (the cache slot there is stale; the
    caller writes it after attention);
  - t > pos: nothing.

On a CUDA tensor ``ancestry_attention`` launches the hand-written kernel
kernels/csrc/ancestry_attn.cu; its plain PyTorch version,
``ancestry_attention_reference``, runs only for CPU tensors. Both follow the
TPU kernel's numerics (beam_attention.py:57-106): fp32 scores and softmax,
history weights rounded to the cache dtype before p.v, the self term in
fp32, the output cast to q's dtype.
"""

from __future__ import annotations

import torch

from ..kernels import DTYPE_CODES, launch_counts, route

HEAD_DIM = 64  # the kernel's only head dim: every Whisper size has it


def ancestor_rows(hist: torch.Tensor, n: int) -> torch.Tensor:
    """(Bb, T) group-local ancestors -> (Bb, T) absolute cache rows."""
    bb = hist.shape[0]
    base = torch.arange(bb, device=hist.device) // n * n
    return base[:, None] + hist.long()


def ancestry_attention_reference(q, k_new, v_new, cache_k, cache_v, hist,
                                 pos: int, n: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel, same math. q/k_new/v_new
    (Bb, H, 1, hd), q pre-scaled; cache_k/cache_v (Bb, H, T, hd) of one
    layer; hist (Bb, T) int. Returns (Bb, H, 1, hd) in q's dtype."""
    rows = ancestor_rows(hist[:, :pos], n)                   # (Bb, pos)
    heads = torch.arange(q.shape[1], device=q.device)
    t_idx = torch.arange(pos, device=q.device)
    # (Bb, H, pos, hd): each hypothesis's ancestral history
    k_hist = cache_k[rows[:, None, :], heads[None, :, None], t_idx]
    v_hist = cache_v[rows[:, None, :], heads[None, :, None], t_idx]
    qf = q.float()
    s_hist = torch.matmul(qf, k_hist.float().transpose(-1, -2))  # (Bb,H,1,pos)
    s_self = (qf * k_new.float()).sum(-1, keepdim=True)           # (Bb,H,1,1)
    scores = torch.cat([s_hist, s_self], dim=-1)
    probs = torch.softmax(scores, dim=-1)
    w_hist = probs[..., :pos].to(cache_v.dtype).float()
    acc = torch.matmul(w_hist, v_hist.float()) \
        + probs[..., pos:] * v_new.float()
    return acc.to(q.dtype)


def ancestry_attention(q, k_new, v_new, cache_k, cache_v, hist, pos: int,
                       n: int) -> torch.Tensor:
    """Beam self-attention of one new token per hypothesis (see the module
    docstring). Shapes as ``ancestry_attention_reference``."""
    if route(q, "ancestry_attention") == "plain":
        return ancestry_attention_reference(q, k_new, v_new, cache_k,
                                            cache_v, hist, pos, n)
    from ..kernels import ancestry_attn_lib

    lib = ancestry_attn_lib()
    bb, h, one, hd = q.shape
    t = cache_k.shape[2]
    if one != 1 or hd != HEAD_DIM:
        raise ValueError(f"ancestry_attention: q {tuple(q.shape)} (kernel "
                         f"takes one query of head dim {HEAD_DIM})")
    for name, x in (("k_new", k_new), ("v_new", v_new)):
        if x.shape != q.shape or x.dtype != q.dtype:
            raise ValueError(f"ancestry_attention: {name} {tuple(x.shape)} "
                             f"{x.dtype} does not match q {tuple(q.shape)} "
                             f"{q.dtype}")
    for name, x in (("cache_k", cache_k), ("cache_v", cache_v)):
        if x.shape != (bb, h, t, hd) or x.dtype != q.dtype:
            raise ValueError(f"ancestry_attention: {name} {tuple(x.shape)} "
                             f"{x.dtype}, want {(bb, h, t, hd)} {q.dtype}")
    if hist.shape != (bb, t):
        raise ValueError(f"ancestry_attention: hist {tuple(hist.shape)}, "
                         f"want {(bb, t)}")
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"ancestry_attention: dtype {q.dtype} (kernel takes "
                         "float32 and bfloat16)")
    if not 0 <= pos < t or n < 1 or bb % n:
        raise ValueError(f"ancestry_attention: pos {pos}, n {n} for "
                         f"Bb={bb}, T={t}")
    for name, x in (("k_new", k_new), ("v_new", v_new), ("cache_k", cache_k),
                    ("cache_v", cache_v), ("hist", hist)):
        if x.device != q.device:
            raise ValueError(f"ancestry_attention: {name} on {x.device}, q "
                             f"on {q.device}")
    q, k_new, v_new = (x.contiguous() for x in (q, k_new, v_new))
    cache_k, cache_v = cache_k.contiguous(), cache_v.contiguous()
    hist = hist.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    err = lib.ancestry_attn(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), cache_k.data_ptr(),
        cache_v.data_ptr(), hist.data_ptr(), out.data_ptr(), bb, h, t, pos, n,
        DTYPE_CODES[q.dtype], q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ancestry_attn launch failed: CUDA error {err}")
    launch_counts["ancestry_attn"] += 1
    return out
