"""Whisper encoder/decoder core of the port, as ``nn.Module``s.

Counterpart of ts_asr_whisper_tpu/models/whisper.py:40-661. Module
and parameter names follow HF ``WhisperForConditionalGeneration``, so a
DiCoW state dict loads strictly. Per-layer weights live in
``nn.ModuleList``s (the JAX package stacks them on a leading axis for
``lax.scan``).

Numerics as the JAX package: parameters may be stored in one dtype and cast
to the compute dtype at use; layer norms, attention softmax and the logits
run in fp32; exact (erf) GELU; q scaled by head_dim**-0.5.

Tensor parallelism (parallel/tensor.py): after ``shard_model_`` each
``Attention`` holds its local heads and each attention and layer its
``model`` group (``tp_group``, None when whole). The inputs of the column-
parallel projections go through ``copy_to_model`` once per distinct input;
``out_proj`` and ``fc2`` are row-parallel (``row_linear``).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from ..ops.attention import plain_sdpa, sdpa
from ..ops.beam_attention import (ancestry_attention,
                                  ancestry_attention_reference)
from ..parallel.tensor import copy_to_model, row_parallel_linear
from ..training.lora import adapted_weight
from ..utils.observability import count
from .config import DiCoWConfig

KVCache = Dict[str, torch.Tensor]
# per decoder layer: the exact (k, v), or the int8 dict of quantize_cross_kv
CrossKV = List[Union[Tuple[torch.Tensor, torch.Tensor],
                     Dict[str, torch.Tensor]]]

# Self-attention KV-cache layout (whisper.py:360-377): 'bhtd'
# (L, B, H, T, hd), the default and the only one of the append-only
# ancestry cache; 'tbhd' (L, T, B, H, hd) and 'thbd' (L, T, H, B, hd) are
# the JAX package's A/B switches, kept for the standalone-permute beam path.
KV_LAYOUTS = ("bhtd", "tbhd", "thbd")
_KV_LAYOUT = "bhtd"


def set_kv_cache_layout(name: str) -> None:
    global _KV_LAYOUT
    assert name in KV_LAYOUTS, name
    _KV_LAYOUT = name


def get_kv_cache_layout() -> str:
    return _KV_LAYOUT


def _as_bhtd(cache: torch.Tensor, layout: str) -> torch.Tensor:
    """One layer's cache in ``layout`` viewed as (B, H, T, hd)."""
    if layout == "tbhd":
        return cache.permute(1, 2, 0, 3)
    if layout == "thbd":
        return cache.permute(2, 1, 0, 3)
    return cache


def linear(m: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x @ W^T + b with weights and input cast to the compute dtype; W
    merged with the LoRA adapters that ``m`` carries (training/lora.py)."""
    b = m.bias.to(dtype) if m.bias is not None else None
    return F.linear(x.to(dtype), adapted_weight(m).to(dtype), b)


def row_linear(m: nn.Linear, x: torch.Tensor, dtype: torch.dtype,
               group) -> torch.Tensor:
    """``linear`` of a row-parallel projection: with a ``model`` group,
    this rank's partial product, summed over the group, then the bias."""
    if group is None:
        return linear(m, x, dtype)
    b = m.bias.to(dtype) if m.bias is not None else None
    return row_parallel_linear(x.to(dtype), m.weight.to(dtype), b, group)


REMAT_POLICIES = ("full", "dots", "attn")


def remat_context(policy: str):
    """``context_fn`` of ``torch.utils.checkpoint`` for a checkpointed
    region under a remat policy (whisper.py:156-174):

    - 'full': save nothing, recompute the whole region;
    - 'dots': save the outputs of the products without batch dimensions,
      ``aten.mm`` and ``aten.addmm`` (what ``F.linear`` becomes, for 2-D
      and 3-D inputs alike); the attention's batched products (``bmm``)
      and convolutions are recomputed, as
      ``dots_with_no_batch_dims_saveable`` leaves them;
    - 'attn': as 'full' within a region. The encoder's layers keep their
      attention core outside the regions instead
      (``DiCoWEncoder._remat_layer``); the decoder's attention (plain
      products) is recomputed."""
    if policy != "dots":
        return noop_context_fn
    saved = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)

    def policy_fn(ctx, func, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if func in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return partial(create_selective_checkpoint_contexts, policy_fn)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


class LayerNorm(nn.Module):
    """Layer norm computed in fp32 (eps 1e-5), cast back to the input dtype."""

    def __init__(self, d: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(x.dtype)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    # (..., T, D) -> (..., H, T, hd)
    *lead, t, d = x.shape
    return x.reshape(*lead, t, num_heads, d // num_heads).transpose(-3, -2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    # (..., H, T, hd) -> (..., T, D)
    x = x.transpose(-3, -2)
    return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])


class Attention(nn.Module):
    """HF WhisperAttention parameters: k_proj has no bias. ``num_heads``
    is the heads this rank holds (all of them unless tensor-sharded).
    ``query`` / ``keys_values`` take their input after ``copy_to_model``
    (``forward`` and ``EncoderLayer.attn_in`` apply it)."""

    def __init__(self, d: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.tp_group = None
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d, bias=False)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)

    def query(self, x: torch.Tensor, dtype) -> torch.Tensor:
        q = linear(self.q_proj, x, dtype)
        head_dim = q.shape[-1] // self.num_heads
        return split_heads(q * head_dim ** -0.5, self.num_heads)

    def keys_values(self, x: torch.Tensor, dtype):
        return (split_heads(linear(self.k_proj, x, dtype), self.num_heads),
                split_heads(linear(self.v_proj, x, dtype), self.num_heads))

    def out(self, attn: torch.Tensor, dtype) -> torch.Tensor:
        """The output projection of the heads' outputs (B, H, T, hd)."""
        return row_linear(self.out_proj, merge_heads(attn), dtype,
                          self.tp_group)

    def forward(self, x_q: torch.Tensor, x_kv: torch.Tensor, dtype,
                mask: Optional[torch.Tensor] = None,
                flash: bool = False) -> torch.Tensor:
        xq = copy_to_model(x_q, self.tp_group)
        xkv = xq if x_kv is x_q else copy_to_model(x_kv, self.tp_group)
        q = self.query(xq, dtype)
        k, v = self.keys_values(xkv, dtype)
        return self.out(sdpa(q, k, v, mask, flash=flash), dtype)


class EncoderLayer(nn.Module):
    def __init__(self, d: int, num_heads: int, ffn: int):
        super().__init__()
        self.tp_group = None
        self.self_attn = Attention(d, num_heads)
        self.self_attn_layer_norm = LayerNorm(d)
        self.fc1 = nn.Linear(d, ffn)
        self.fc2 = nn.Linear(ffn, d)
        self.final_layer_norm = LayerNorm(d)

    def mlp(self, x: torch.Tensor, dtype) -> torch.Tensor:
        h = gelu(linear(self.fc1, copy_to_model(x, self.tp_group), dtype))
        return row_linear(self.fc2, h, dtype, self.tp_group)

    def attn_in(self, x: torch.Tensor, dtype):
        """q, k, v of the self-attention over the pre-norm of x."""
        h = copy_to_model(self.self_attn_layer_norm(x), self.tp_group)
        return (self.self_attn.query(h, dtype),
                *self.self_attn.keys_values(h, dtype))

    def attn_out(self, x: torch.Tensor, out: torch.Tensor, dtype):
        """The rest of the layer from the attention core's output: output
        projection and residual, then the MLP block."""
        x = x + self.self_attn.out(out, dtype)
        return x + self.mlp(self.final_layer_norm(x), dtype)

    def forward(self, x: torch.Tensor, dtype, flash: bool = False):
        out = sdpa(*self.attn_in(x, dtype), flash=flash)
        return self.attn_out(x, out, dtype)


class DecoderLayer(EncoderLayer):
    def __init__(self, d: int, num_heads: int, ffn: int):
        super().__init__(d, num_heads, ffn)
        self.encoder_attn = Attention(d, num_heads)
        self.encoder_attn_layer_norm = LayerNorm(d)

    def forward(self, x: torch.Tensor, enc: torch.Tensor, dtype,
                self_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.self_attn_layer_norm(x)
        x = x + self.self_attn(h, h, dtype, mask=self_mask)
        h = self.encoder_attn_layer_norm(x)
        x = x + self.encoder_attn(h, enc, dtype)
        return x + self.mlp(self.final_layer_norm(x), dtype)


def quantize_cross_kv(cross_kv: CrossKV) -> CrossKV:
    """Symmetric per-row int8 quantization of the cross-attention cache
    (whisper.py:301-325): per (batch, head, position) row, scale =
    max|x| / 127 clamped at 1e-8, codes round(x / scale) (half to even, as
    ``jnp.round``) clipped to [-127, 127]. Lossy: opt-in through
    ``GenerationConfig.cross_kv_quant``."""
    def quant(x):
        xf = x.float()
        scale = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) / 127.0,
                            min=1e-8)
        q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
        return q, scale

    out = []
    for k, v in cross_kv:
        k_q, k_scale = quant(k)
        v_q, v_scale = quant(v)
        out.append({"k_q": k_q, "k_scale": k_scale, "v_q": v_q,
                    "v_scale": v_scale})
    return out


def cross_attention(q: torch.Tensor, cross, dtype) -> torch.Tensor:
    """Decoder cross-attention, q pre-scaled, (B_q, H, T_q, hd), over one
    layer's exact ``(k, v)`` or int8 dict (whisper.py:327-359). When q's
    batch is a multiple n of the cross-KV batch (beam search: n hypotheses
    per audio row), the n beams fold into the query axis instead of the K/V
    being repeated per beam: same math, since cross-attention has no
    position mask, and the cross-KV read stays at audio-batch size.

    The int8 cache folds its scales into the attention: the fp32 scores
    are multiplied by ``k_scale`` per key row, the probabilities by
    ``v_scale`` before their cast to the compute dtype and ``p.v``. Eager
    PyTorch materialises the codes cast to the compute dtype."""
    quant = isinstance(cross, dict)
    b_kv, bq = (cross["k_q"] if quant else cross[0]).shape[0], q.shape[0]
    if bq != b_kv:
        n = bq // b_kv
        _, h, tq, hd = q.shape
        qf = q.reshape(b_kv, n, h, tq, hd).transpose(1, 2) \
            .reshape(b_kv, h, n * tq, hd)
        out = cross_attention(qf, cross, dtype)
        out = out.reshape(b_kv, h, n, tq, hd).transpose(1, 2)
        return out.reshape(bq, h, tq, hd)
    if not quant:
        return plain_sdpa(q, *cross)
    scores = torch.matmul(q.float(), cross["k_q"].float().transpose(-1, -2))
    scores = scores * cross["k_scale"][..., 0][:, :, None, :]
    probs = torch.softmax(scores, dim=-1)
    pv = probs * cross["v_scale"][..., 0][:, :, None, :]
    return torch.matmul(pv.to(dtype), cross["v_q"].to(dtype))


class _StepBuffers(dict):
    """The fixed-address buffers of the single-token step at one key: the
    self-attention cache itself ("k", "v"), its cross-KV, the step's tokens
    (B, 1) and its position (1,) on the device; and the step's CUDA graph
    over them, with the addresses of the parameters it was captured on.
    ``decoder_cached`` knows such a cache by its type."""

    def __init__(self, kv_cache: KVCache, cross_kv: CrossKV, batch: int,
                 device: torch.device):
        super().__init__(kv_cache)
        self.cross = cross_kv
        self.ids = torch.zeros((batch, 1), dtype=torch.long, device=device)
        self.pos = torch.zeros((1,), dtype=torch.long, device=device)
        self.graph = self.out = self.params = None


class _StepPools(dict):
    """A decoder's ``_StepBuffers`` by key. A copy of the decoder (deepcopy,
    pickling) starts with none: buffers and graphs stay with the decoder
    that made them, and are freed with it."""

    def __deepcopy__(self, memo):
        return _StepPools()

    def __reduce__(self):
        return (_StepPools, ())


def _is_dtensor(t: torch.Tensor) -> bool:
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def sinusoidal_positions(length: int, d_model: int) -> np.ndarray:
    """Whisper encoder sinusoids (whisper.py:807-812)."""
    log_timescale = math.log(10000) / (d_model // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(d_model // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)],
                          axis=1).astype(np.float32)


class WhisperDecoder(nn.Module):
    def __init__(self, cfg: DiCoWConfig):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, d)
        self.embed_positions = nn.Embedding(cfg.max_target_positions, d)
        self.layers = nn.ModuleList(
            DecoderLayer(d, cfg.decoder_attention_heads, cfg.decoder_ffn_dim)
            for _ in range(cfg.decoder_layers))
        self.layer_norm = LayerNorm(d)
        # None, or the remat policy: see DiCoW.set_gradient_checkpointing
        self.remat = None
        # the greedy step's buffers and graphs: see greedy_buffers
        self._step_pools = _StepPools()

    def embed(self, input_ids: torch.Tensor, pos0: int) -> torch.Tensor:
        dt = self.cfg.compute_dtype
        t = input_ids.shape[-1]
        pos = self.embed_positions.weight[pos0: pos0 + t]
        return self.embed_tokens.weight[input_ids].to(dt) + pos.to(dt)

    def forward(self, input_ids: torch.Tensor, encoder_hidden: torch.Tensor,
                position_offset: int = 0) -> torch.Tensor:
        """Teacher-forced decoder (whisper.py:251-267): (B, T) tokens ->
        (B, T, D) final hidden. Each projection with LoRA adapters merges
        them in its own call (``linear``), once per layer forward, as the
        JAX package merges once in the loss (trainer.py:64-68)."""
        dt = self.cfg.compute_dtype
        x = self.embed(input_ids, position_offset)
        t = input_ids.shape[-1]
        mask = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
        enc = encoder_hidden.to(dt)
        for layer in self.layers:
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(layer, x, enc, dt, mask, use_reentrant=False,
                               context_fn=remat_context(self.remat))
            else:
                x = layer(x, enc, dt, mask)
        return self.layer_norm(x)

    def lm_logits(self, hidden: torch.Tensor,
                  weight_f32: Optional[torch.Tensor] = None) -> torch.Tensor:
        """proj_out tied to embed_tokens, fp32 accumulation of the compute-
        dtype operands (whisper.py:270-274). ``weight_f32`` is
        ``embed_tokens`` cast to the hidden dtype and then to fp32, for
        callers that take logits every step."""
        if weight_f32 is None:
            weight_f32 = self.embed_tokens.weight.to(hidden.dtype).float()
        return F.linear(hidden.float(), weight_f32)

    def precompute_cross_kv(self, encoder_hidden: torch.Tensor) -> CrossKV:
        """Cross-attention K/V of every layer, (B, H, T_enc, hd) each."""
        dt = self.cfg.compute_dtype
        enc = encoder_hidden.to(dt)
        return [layer.encoder_attn.keys_values(enc, dt)
                for layer in self.layers]

    def init_kv_cache(self, batch: int, max_len: int,
                      device: torch.device) -> KVCache:
        """Zeroed self-attention cache in the current layout
        (whisper.py:380-393)."""
        c = self.cfg
        heads = c.decoder_attention_heads
        head_dim = c.d_model // heads
        shape = {"tbhd": (max_len, batch, heads, head_dim),
                 "thbd": (max_len, heads, batch, head_dim),
                 "bhtd": (batch, heads, max_len, head_dim)}[_KV_LAYOUT]
        shape = (c.decoder_layers, *shape)
        return {"k": torch.zeros(shape, dtype=c.compute_dtype, device=device),
                "v": torch.zeros(shape, dtype=c.compute_dtype, device=device)}

    def greedy_buffers(self, encoder_hidden: torch.Tensor, batch: int,
                       max_len: int, quant: bool) -> Tuple[KVCache, CrossKV]:
        """A zeroed self-attention cache and the cross-KV of
        ``encoder_hidden`` (int8 under ``quant``), in buffers of this
        decoder's own that keep their addresses from one decode to the next:
        one set per key (batch rows, cache length, encoder frames, cross-KV
        kind, compute dtype, cache layout, device). The cache is the pooled
        ``_StepBuffers`` entry, on which ``decoder_cached`` runs its
        single-token steps through ``decoder_step``, replayed as a CUDA
        graph on the card. A decoder split over a ``model`` group or into
        DTensors gets a plain cache dict, which takes the eager step."""
        cross = self.precompute_cross_kv(encoder_hidden)
        if quant:
            cross = quantize_cross_kv(cross)
        dev = encoder_hidden.device
        params = self._static_params()
        if params is None:
            return self.init_kv_cache(batch, max_len, dev), cross
        key = (batch, max_len, encoder_hidden.shape[1], quant,
               self.cfg.compute_dtype, _KV_LAYOUT, dev)
        bufs = self._step_pools.get(key)
        if bufs is None:
            bufs = self._step_pools[key] = _StepBuffers(
                self.init_kv_cache(batch, max_len, dev), cross, batch, dev)
        else:
            for c in bufs.values():
                c.zero_()
            for dst, src in zip(bufs.cross, cross):
                if isinstance(dst, dict):
                    dst, src = dst.values(), src.values()
                for d, s in zip(dst, src):
                    d.copy_(s)
        if bufs.params != params:
            # a graph reads the parameters at the addresses it was captured
            # on: recapture after a cast, a reload by assignment, or a
            # change of the adapters
            bufs.graph = bufs.out = None
            bufs.params = params
        return bufs, bufs.cross

    def _static_params(self) -> Optional[Tuple[int, ...]]:
        """The parameters' addresses, or None if a layer is split over a
        ``model`` group or a parameter is a DTensor."""
        params = list(self.parameters())
        if any(_is_dtensor(p) for p in params) or any(
                getattr(m, "tp_group", None) is not None
                for m in self.modules()):
            return None
        return tuple(p.data_ptr() for p in params)

    def decoder_cached(self, input_ids: torch.Tensor, pos: int,
                       kv_cache: KVCache, cross_kv: CrossKV,
                       alignment_slots: Optional[torch.Tensor] = None):
        """Run T_new tokens at positions pos.. through the decoder, writing
        their K/V into ``kv_cache`` (current layout) in place
        (whisper.py:396-549). Returns the final hidden (B, T_new, D).
        ``cross_kv`` may hold B / n audio rows for B = n beams per row.

        With ``alignment_slots`` (L, S, H), the one-hot head selection of
        token-timestamp collection, it returns (hidden, probs): the
        cross-attention probabilities (B, S, T_new, T_enc) in fp32 of the S
        alignment slots. Each layer takes softmax(q.k^T) in fp32 over its
        exact cache and adds the slots it owns (its rows of the selection;
        the other rows are zero) into the sum (whisper.py:516-549). The
        int8 cache cannot serve it (ValueError, as the JAX package
        asserts).

        Query i sees cache keys j <= pos + i (whisper.py:443-446), with fp32
        scores masked by finfo(float32).min in every layout; the keys past
        pos + T_new are left out instead of masked, which changes no value:
        a masked key's probability is exactly 0.

        One token on a cache of ``greedy_buffers`` with its own cross-KV,
        without ``alignment_slots`` and no gradient, runs ``decoder_step``
        instead: on the card as a CUDA graph, captured the first time its
        buffers are used and replayed from then on. Its hidden state is
        then the graph's output buffer, which the next step on the same
        buffers overwrites."""
        if (isinstance(kv_cache, _StepBuffers) and cross_kv is kv_cache.cross
                and alignment_slots is None and input_ids.shape[-1] == 1
                and not torch.is_grad_enabled()):
            return self._buffered_step(kv_cache, input_ids, pos)
        if alignment_slots is not None and isinstance(cross_kv[0], dict):
            raise ValueError(
                "alignment collection needs the exact cross-KV cache")
        t_new = input_ids.shape[-1]
        end = pos + t_new
        x = self.embed(input_ids, pos)
        key_pos = torch.arange(end, device=x.device)
        q_pos = pos + torch.arange(t_new, device=x.device)
        self_mask = key_pos[None, :] <= q_pos[:, None]      # (T_new, end)

        def attend(q, k_new, v_new, ks, vs):
            ks[:, :, pos:end] = k_new
            vs[:, :, pos:end] = v_new
            return plain_sdpa(q, ks[:, :, :end], vs[:, :, :end], self_mask)

        x, probs = self._cached_layers(x, kv_cache, attend, cross_kv,
                                       alignment_slots)
        return x if alignment_slots is None else (x, probs)

    def decoder_step(self, ids: torch.Tensor, pos: torch.Tensor,
                     kv_cache: KVCache, cross_kv: CrossKV) -> torch.Tensor:
        """One token a row, ids (B, 1), at the position ``pos``, a (1,)
        int64 tensor on the device, through the decoder over static shapes:
        the body that ``decoder_cached`` replays as a CUDA graph. The
        embedding reads the position with ``index_select``, K/V are written
        at it with ``index_copy_``, and the self-attention covers the whole
        cache, its keys past ``pos`` masked by finfo(float32).min
        (probability exactly 0), as the JAX loop computes it
        (whisper.py:443-446). Returns the final hidden (B, 1, D)."""
        dt = self.cfg.compute_dtype
        x = (self.embed_tokens.weight.index_select(0, ids[:, 0]).to(dt)
             + self.embed_positions.weight.index_select(0, pos).to(dt))
        x = x[:, None]
        max_len = _as_bhtd(kv_cache["k"][0], _KV_LAYOUT).shape[2]
        mask = torch.arange(max_len, device=ids.device)[None, :] \
            <= pos[:, None]                                   # (1, T)

        def attend(q, k_new, v_new, ks, vs):
            ks.index_copy_(2, pos, k_new)
            vs.index_copy_(2, pos, v_new)
            return plain_sdpa(q, ks, vs, mask)

        return self._cached_layers(x, kv_cache, attend, cross_kv)[0]

    def _cached_layers(self, x: torch.Tensor, kv_cache: KVCache,
                       attend_self, cross_kv: CrossKV,
                       alignment_slots: Optional[torch.Tensor] = None):
        """The decoder's layers over a self-attention cache, then the final
        layer norm. Per layer: the pre-norm, q and the new K/V, then
        ``attend_self(q, k_new, v_new, ks, vs)`` with the layer's cache
        viewed as (B, H, T, hd), which writes the new K/V into it and
        returns the attention's output; the output projection and residual;
        the cross-attention and MLP blocks. Returns (hidden, the alignment
        slots' probabilities summed over the layers, or None)."""
        dt = self.cfg.compute_dtype
        probs = None
        for li, layer in enumerate(self.layers):
            h = layer.self_attn_layer_norm(x)
            q = layer.self_attn.query(h, dt)
            k_new, v_new = layer.self_attn.keys_values(h, dt)
            attn = attend_self(q, k_new, v_new,
                               _as_bhtd(kv_cache["k"][li], _KV_LAYOUT),
                               _as_bhtd(kv_cache["v"][li], _KV_LAYOUT))
            x = x + layer.self_attn.out(attn, dt)
            h = layer.encoder_attn_layer_norm(x)
            q = layer.encoder_attn.query(h, dt)
            x = x + layer.encoder_attn.out(
                cross_attention(q, cross_kv[li], dt), dt)
            x = x + layer.mlp(layer.final_layer_norm(x), dt)
            if alignment_slots is not None:
                scores = torch.matmul(
                    q.float(), cross_kv[li][0].float().transpose(-1, -2))
                sel = torch.einsum("sh,bhqt->bsqt",
                                   alignment_slots[li].float(),
                                   torch.softmax(scores, dim=-1))
                probs = sel if probs is None else probs + sel
        return self.layer_norm(x), probs

    def _buffered_step(self, bufs: _StepBuffers, input_ids: torch.Tensor,
                       pos: int) -> torch.Tensor:
        """``decoder_step`` on ``bufs``: run as it is off the card; on the
        card its graph replayed, captured first if ``bufs`` has none."""
        bufs.ids.copy_(input_ids)
        bufs.pos.fill_(pos)
        if bufs.ids.device.type != "cuda":
            return self.decoder_step(bufs.ids, bufs.pos, bufs, bufs.cross)
        if bufs.graph is None:
            self._capture(bufs)
        bufs.graph.replay()
        count("greedy.graph_replays")
        return bufs.out

    def _capture(self, bufs: _StepBuffers) -> None:
        """Capture ``decoder_step`` on ``bufs`` as a CUDA graph. It reads the
        parameters where they lie at each replay, so in-place updates (the
        optimizer's) reach it; only its intermediates are its own."""
        step = partial(self.decoder_step, bufs.ids, bufs.pos, bufs,
                       bufs.cross)
        with torch.cuda.device(bufs.ids.device):
            # one run on a side stream first, as torch.cuda.graphs asks, so
            # that the libraries set up outside the capture; it writes the
            # K/V that the replay writes again
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                step()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                bufs.out = step()
        bufs.graph = graph
        count("greedy.graph_captures")

    def decoder_cached_ancestry(self, input_ids: torch.Tensor, pos: int,
                                kv_cache: KVCache, cross_kv: CrossKV,
                                hist: torch.Tensor, n: int,
                                attn_impl: str = "kernel") -> torch.Tensor:
        """One token per hypothesis through the decoder for beam search on an
        append-only cache (whisper.py:552-661): input_ids (Bb, 1); kv_cache
        (L, Bb, H, T, hd), never permuted; hist (Bb, T) the group-local
        ancestor row of each position; n beams per audio row of
        ``cross_kv``. Each layer's self-attention reads the pre-update cache
        through ``ops/beam_attention.py``: ``ancestry_attention`` (the CUDA
        kernel on the card) for ``attn_impl='kernel'``, the reorder impl
        'ancestry_pallas'; its plain version on any device for 'plain', the
        impl 'ancestry'. Then this step's K/V is written at ``pos`` in place.
        Needs the 'bhtd' layout. Returns the final hidden (Bb, 1, D)."""
        assert _KV_LAYOUT == "bhtd", (
            "ancestry reorder requires the 'bhtd' KV-cache layout, got "
            f"{_KV_LAYOUT!r}")
        attend = {"kernel": ancestry_attention,
                  "plain": ancestry_attention_reference}[attn_impl]

        def attend_self(q, k_new, v_new, ks, vs):
            attn = attend(q, k_new, v_new, ks, vs, hist, pos, n)
            ks[:, :, pos] = k_new[:, :, 0]
            vs[:, :, pos] = v_new[:, :, 0]
            return attn

        x = self.embed(input_ids, pos)
        return self._cached_layers(x, kv_cache, attend_self, cross_kv)[0]
