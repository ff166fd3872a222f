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
``ancestry_attention_reference``, runs only for CPU tensors. ``pos`` is a
Python int or a one-element int32 tensor: the kernel reads it on the card,
so its launch does not depend on it. Both follow the TPU kernel's numerics
(beam_attention.py:57-106): fp32 scores and softmax, history weights
rounded to the cache dtype before p.v, the self term in fp32, the output
cast to q's dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import DTYPE_CODES, launch_counts, raw_stream, route

HEAD_DIM = 64  # the kernel's only head dim: every Whisper size has it
# pos given as a Python int reaches the kernel as a pointer into a
# per-device int32 arange of this length, made once and never freed (a
# captured launch may hold a pointer into it), so no call copies a scalar
# to the card
MAX_POSITIONS = 8192
_positions: dict = {}
# CUDA's cudaErrorInvalidValue: what the kernel's entry point returns for a
# shape it cannot take
_INVALID_VALUE = 1


def ancestor_rows(hist: torch.Tensor, n: int) -> torch.Tensor:
    """(Bb, T) group-local ancestors -> (Bb, T) absolute cache rows."""
    bb = hist.shape[0]
    base = torch.arange(bb, device=hist.device) // n * n
    return base[:, None] + hist.long()


def beam_search_history(rng: np.random.Generator, b: int, n: int,
                        t: int) -> np.ndarray:
    """(b * n, t) int32 ancestry map as a beam search builds it
    (decoding/beam.py: ``hist = hist[flat_beam_idx]``, then
    ``hist[:, cur_len] = group_rows``): every row starts as its own group
    row, and at each step 1 .. t - 1 each row inherits the history of a beam
    drawn from ``rng`` within its group, with repeats, so beams share
    prefixes. Test and smoke-run input for the kernel."""
    bb = b * n
    group_rows = np.tile(np.arange(n, dtype=np.int32), b)
    hist = np.repeat(group_rows[:, None], t, axis=1)
    base = np.arange(b)[:, None] * n
    for cur in range(1, t):
        chosen = rng.integers(0, n, size=(b, n))
        hist = hist[(base + chosen).reshape(bb)]
        hist[:, cur] = group_rows
    return hist


def ancestry_attention_reference(q, k_new, v_new, cache_k, cache_v, hist,
                                 pos, n: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel, same math. q/k_new/v_new
    (Bb, H, 1, hd), q pre-scaled; cache_k/cache_v (Bb, H, T, hd) of one
    layer; hist (Bb, T) int; pos a Python int or a one-element integer
    tensor. Returns (Bb, H, 1, hd) in q's dtype."""
    pos = int(pos)
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


def _pos_pointer(pos, t: int, device: torch.device) -> int:
    """Device address of an int32 holding pos: the caller's one-element
    int32 tensor, or the slot of the per-device arange for a Python int."""
    if isinstance(pos, torch.Tensor):
        if (pos.numel() != 1 or pos.dtype != torch.int32
                or pos.device != device):
            raise ValueError(f"ancestry_attention: pos tensor {pos.dtype} "
                             f"{tuple(pos.shape)} on {pos.device}, want one "
                             f"int32 on {device}")
        return pos.data_ptr()
    if not 0 <= pos < min(t, MAX_POSITIONS):
        raise ValueError(f"ancestry_attention: pos {pos} for T={t}")
    table = _positions.get(device)
    if table is None:
        table = torch.arange(MAX_POSITIONS, dtype=torch.int32, device=device)
        _positions[device] = table
    return table.data_ptr() + 4 * pos


def ancestry_attention(q, k_new, v_new, cache_k, cache_v, hist, pos,
                       n: int) -> torch.Tensor:
    """Beam self-attention of one new token per hypothesis (see the module
    docstring). Shapes as ``ancestry_attention_reference``; ``pos`` is a
    Python int or a one-element int32 tensor on q's device, which the
    kernel reads on the card (so one launch captured in a CUDA graph
    replays at whatever position the tensor holds)."""
    if route(q, "ancestry_attention") == "plain":
        return ancestry_attention_reference(q, k_new, v_new, cache_k,
                                            cache_v, hist, pos, n)
    from ..kernels import ancestry_attn_lib

    bb, h, one, hd = q.shape
    t = cache_k.shape[2]
    if (one != 1 or hd != HEAD_DIM or k_new.shape != q.shape
            or v_new.shape != q.shape or cache_k.shape != (bb, h, t, hd)
            or cache_v.shape != cache_k.shape or hist.shape != (bb, t)):
        raise ValueError(
            f"ancestry_attention: q/k_new/v_new {tuple(q.shape)} "
            f"{tuple(k_new.shape)} {tuple(v_new.shape)}, caches "
            f"{tuple(cache_k.shape)} {tuple(cache_v.shape)}, hist "
            f"{tuple(hist.shape)}: want (Bb, H, 1, {HEAD_DIM}) for the new "
            "token, (Bb, H, T, hd) for the caches, (Bb, T) for hist")
    dt = q.dtype
    if dt not in DTYPE_CODES or not (
            k_new.dtype == v_new.dtype == cache_k.dtype == cache_v.dtype
            == dt):
        raise ValueError(f"ancestry_attention: dtypes {dt} {k_new.dtype} "
                         f"{v_new.dtype} {cache_k.dtype} {cache_v.dtype} "
                         "(kernel takes one of float32 and bfloat16)")
    dev = q.device
    if not (k_new.device == v_new.device == cache_k.device == cache_v.device
            == hist.device == dev):
        raise ValueError(f"ancestry_attention: tensors on {k_new.device} "
                         f"{v_new.device} {cache_k.device} {cache_v.device} "
                         f"{hist.device}, q on {dev}")
    if n < 1 or bb % n:
        raise ValueError(f"ancestry_attention: n {n} for Bb={bb}")
    pos_ptr = _pos_pointer(pos, t, dev)
    if not (q.is_contiguous() and k_new.is_contiguous()
            and v_new.is_contiguous()):
        q, k_new, v_new = (x.contiguous() for x in (q, k_new, v_new))
    if not (cache_k.is_contiguous() and cache_v.is_contiguous()):
        cache_k, cache_v = cache_k.contiguous(), cache_v.contiguous()
    if hist.dtype != torch.int32 or not hist.is_contiguous():
        hist = hist.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    lib = ancestry_attn_lib()
    err = lib.ancestry_attn(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), cache_k.data_ptr(),
        cache_v.data_ptr(), hist.data_ptr(), pos_ptr, out.data_ptr(), bb, h,
        t, n, DTYPE_CODES[dt], dev.index or 0, raw_stream(dev))
    if err != 0:
        # the kernel holds a CTA's slice of K and V in shared memory: the
        # one limit the checks above leave to it
        max_len = lib.ancestry_attn_max_len(DTYPE_CODES[dt])
        if err == _INVALID_VALUE and t > max_len:
            raise ValueError(f"ancestry_attention: T={t} > {max_len}, the "
                             f"kernel's limit in {dt}")
        raise RuntimeError(f"ancestry_attn launch failed: CUDA error {err}")
    launch_counts["ancestry_attn"] += 1
    return out
