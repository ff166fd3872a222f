"""Beam-hypothesis KV-cache reorder of the port: the reorder switch and the
standalone permute of the self-attention cache.

Counterpart of ts_asr_whisper_tpu/ops/reorder.py. Each beam step permutes the
cache by the chosen ancestor rows, unless the impl avoids the permute:

- 'pallas': a standalone gather-copy of each of ``k`` and ``v``. For CUDA
  tensors in the 'bhtd' and 'tbhd' layouts it is the hand-written kernel
  kernels/csrc/kv_reorder.cu (``kv_reorder_bhtd`` / ``kv_reorder_tbhd``);
  for CPU tensors its plain PyTorch version, ``cache[:, idx]`` or
  ``cache[:, :, idx]``. 'thbd' has no kernel (nor had the TPU) and takes
  the one-hot product.
- 'onehot': the block-diagonal one-hot product, exact in any dtype (one
  nonzero per output row).
- 'fused' / 'fused_onehot': the permute in place, into the cache's own
  storage: a row gather along the hypothesis dim ('fused') or the one-hot
  product ('fused_onehot'). The JAX package applies them per layer inside
  its decoder step; the caches of the layers are independent, so permuting
  all of them before the step gives the same values, and both are exact.
- 'ancestry' / 'ancestry_pallas': an append-only cache that is never
  permuted (``decoder_cached_ancestry``); '_pallas' reads it through the
  ancestry kernel, 'ancestry' through its plain version, also on the card.
- 'auto': 'ancestry_pallas' on the card, 'pallas' elsewhere, as the JAX
  package resolves it with the TPU in the card's place.

Cache layouts (models/whisper.py::set_kv_cache_layout): 'bhtd'
(L, Bb, H, T, hd), the default; 'tbhd' (L, T, Bb, H, hd); 'thbd'
(L, T, H, Bb, hd).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels import DTYPE_CODES, launch_counts, route

IMPLS = ("auto", "onehot", "pallas", "fused", "fused_onehot", "ancestry",
         "ancestry_pallas")
_IMPL = "auto"
# the hypothesis dim of a whole (L, ...) cache tensor, per layout
_HYP_DIM = {"bhtd": 1, "tbhd": 2, "thbd": 3}


def set_reorder_impl(impl: str) -> None:
    """Strategy for applying the beam permutation (see the module
    docstring); all of them give the same tokens and scores."""
    global _IMPL
    assert impl in IMPLS, impl
    _IMPL = impl


def get_reorder_impl(raw: bool = False,
                     device: Optional[torch.device] = None) -> str:
    """The resolved impl for a beam search on ``device`` (default: the card
    when there is one). ``raw=True`` returns the configured value, 'auto'
    included, so that a save / restore round-trips."""
    if raw or _IMPL != "auto":
        return _IMPL
    if device is None:
        on_card = torch.cuda.is_available()
    else:
        on_card = torch.device(device).type == "cuda"
    return "ancestry_pallas" if on_card else "pallas"


def reorder_bhtd_reference(cache: torch.Tensor,
                           idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``kv_reorder_bhtd``: (L, Bb, H, T, hd),
    out[l, b] = cache[l, idx[b]]."""
    return cache[:, idx.long()]


def reorder_tbhd_reference(cache: torch.Tensor,
                           idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``kv_reorder_tbhd``: (L, T, Bb, H, hd),
    out[l, t, b] = cache[l, t, idx[b]]."""
    return cache[:, :, idx.long()]


def _launch(name: str, cache: torch.Tensor, idx: torch.Tensor,
            hyp_dim: int) -> torch.Tensor:
    """Launch ``kv_reorder_{bhtd,tbhd}`` over ``cache`` gathered along
    ``hyp_dim`` (1 or 2) into a new tensor."""
    from ..kernels import kv_reorder_lib

    lib = kv_reorder_lib()
    if cache.ndim != 5 or cache.dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: cache {tuple(cache.shape)} {cache.dtype} "
                         "(kernel takes a 5-D float32 or bfloat16 cache)")
    bb = cache.shape[hyp_dim]
    if idx.shape != (bb,) or idx.device != cache.device:
        raise ValueError(f"{name}: idx {tuple(idx.shape)} on {idx.device}, "
                         f"want ({bb},) on {cache.device}")
    cache = cache.contiguous()
    outer = cache.shape[:hyp_dim].numel()
    slab_bytes = cache.shape[hyp_dim + 1:].numel() * cache.element_size()
    out = torch.empty_like(cache)
    if slab_bytes % 16 or cache.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError(f"{name}: hypothesis slabs of {slab_bytes} bytes "
                         "are not 16-byte aligned")
    idx = idx.to(torch.int32).contiguous()
    err = getattr(lib, name)(
        cache.data_ptr(), idx.data_ptr(), out.data_ptr(), outer, bb,
        slab_bytes, cache.device.index or 0,
        torch.cuda.current_stream(cache.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    launch_counts[name] += 1
    return out


def reorder_bhtd(cache: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(L, Bb, H, T, hd) cache, (Bb,) source rows in [0, Bb) -> the cache
    with out[l, b] = cache[l, idx[b]], in a new tensor. Rows may repeat."""
    if route(cache, "reorder_bhtd") == "plain":
        return reorder_bhtd_reference(cache, idx)
    return _launch("kv_reorder_bhtd", cache, idx, 1)


def reorder_tbhd(cache: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(L, T, Bb, H, hd) cache -> out[l, t, b] = cache[l, t, idx[b]], in a
    new tensor."""
    if route(cache, "reorder_tbhd") == "plain":
        return reorder_tbhd_reference(cache, idx)
    return _launch("kv_reorder_tbhd", cache, idx, 2)


def _reorder_onehot(chosen_beam: torch.Tensor, cache: torch.Tensor, n: int,
                    layout: str = "bhtd") -> torch.Tensor:
    """chosen_beam: (B, n) per-row source beam in [0, n); the product with
    its block-diagonal one-hot (reorder.py:95-114)."""
    onehot = torch.nn.functional.one_hot(chosen_beam.long(), n) \
        .to(cache.dtype)                                       # (B, n, n)
    if layout == "tbhd":
        l, t, bb, h, d = cache.shape
        g = cache.reshape(l, t, bb // n, n, h, d)
        out = torch.einsum("boi,ltbihd->ltbohd", onehot, g)
    elif layout == "thbd":
        l, t, h, bb, d = cache.shape
        g = cache.reshape(l, t, h, bb // n, n, d)
        out = torch.einsum("boi,lthbid->lthbod", onehot, g)
    else:
        l, bb, h, t, d = cache.shape
        g = cache.reshape(l, bb // n, n, h, t, d)
        out = torch.einsum("boi,lbihtd->lbohtd", onehot, g)
    return out.reshape(cache.shape)


def beam_reorder(cache: torch.Tensor, chosen_beam: torch.Tensor, n: int,
                 flat_idx: torch.Tensor, layout: str = "bhtd"
                 ) -> torch.Tensor:
    """Permute the hypotheses of one self-attention cache tensor: into a new
    tensor, or in place for 'fused' / 'fused_onehot' (which return
    ``cache``).

    chosen_beam: (B, n) source beam within each audio row's group; flat_idx:
    (Bb,) the same permutation as absolute rows. Branches on the resolved
    impl, so 'auto' and an explicit setting take the same path."""
    impl = get_reorder_impl(device=cache.device)
    if impl == "fused":
        return cache.copy_(cache.index_select(_HYP_DIM[layout],
                                              flat_idx.long()))
    if impl == "pallas" and layout != "thbd":
        if layout == "tbhd":
            return reorder_tbhd(cache, flat_idx)
        return reorder_bhtd(cache, flat_idx)
    out = _reorder_onehot(chosen_beam, cache, n, layout)
    return cache.copy_(out) if impl == "fused_onehot" else out
