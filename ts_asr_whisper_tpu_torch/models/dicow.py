"""DiCoW / SE-DiCoW model of the port: the STNO-conditioned Whisper encoder
with SE-DiCoW's enrollment stream and SCBs, the CTC head and the full
encoder-decoder with HF parameter names.

Counterpart of ts_asr_whisper_tpu/models/dicow.py (``scb_forward``,
``init_scb``, ``dicow_encoder_forward``, ``encoder_ctc_logits``, the
teacher-forced ``dicow_forward``, ``init_dicow``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import sdpa
from .config import DiCoWConfig
from .fddt import FDDT
from .whisper import (
    REMAT_POLICIES,
    Attention,
    EncoderLayer,
    LayerNorm,
    WhisperDecoder,
    gelu,
    linear,
    remat_context,
    sinusoidal_positions,
)


class _Gate(nn.Module):
    def __init__(self):
        super().__init__()
        self.gate = nn.Parameter(torch.zeros(1))


class _CrossAttentionEnroll(nn.Module):
    """The parameters of one SCB under their HF names: ``cross_attn``,
    ``ffn.0`` (2D -> ffn), ``ffn.3`` (ffn -> D), ``cross_gate.gate``."""

    def __init__(self, d: int, num_heads: int, ffn: int):
        super().__init__()
        self.cross_attn = Attention(d, num_heads)
        self.ffn = nn.ModuleDict({"0": nn.Linear(2 * d, ffn),
                                  "3": nn.Linear(ffn, d)})
        self.cross_gate = _Gate()


class SCB(nn.Module):
    """SE-DiCoW speaker-communication block (dicow.py:53-69): the sample
    stream attends to the enrollment stream, and only the sample stream is
    updated, through a zero-initialised tanh gate."""

    def __init__(self, d: int, num_heads: int, ffn: int):
        super().__init__()
        self.cae = _CrossAttentionEnroll(d, num_heads, ffn)

    def forward(self, x: torch.Tensor, dtype,
                flash: bool = False) -> torch.Tensor:
        """x (B, 2, T, D): stream 0 the sample (query), stream 1 the
        enrollment (keys and values) -> (B, 2, T, D)."""
        p = self.cae
        q, kv = x[:, 0], x[:, 1]
        attn = p.cross_attn(q, kv, dtype, flash=flash)
        h = gelu(linear(p.ffn["0"], torch.cat([attn, q], dim=-1), dtype))
        h = linear(p.ffn["3"], h, dtype)
        gate = torch.tanh(p.cross_gate.gate.to(dtype))
        return torch.stack([q + gate * h, kv], dim=1)


class DiCoWEncoder(nn.Module):
    """Whisper encoder (conv stem, learned positions, layer stack, final
    norm) with initial and per-layer FDDT, SE-DiCoW's SCBs and the optional
    CTC head modules (built so that DiCoW and SE-DiCoW state dicts load
    strictly). ``flash`` routes the self-attention and the SCB cross-
    attention through ``ops/attention.py::flash_mha_fwd``."""

    def __init__(self, cfg: DiCoWConfig, flash: bool = False):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        self.flash = flash
        # None, or the remat policy under which each layer after the SCB
        # region (its FDDT included) is recomputed in the backward pass
        # (training.gradient_checkpointing, DiCoW.set_gradient_checkpointing)
        self.remat = None
        self.conv1 = nn.Conv1d(cfg.num_mel_bins, d, 3, padding=1)
        self.conv2 = nn.Conv1d(d, d, 3, stride=2, padding=1)
        self.embed_positions = nn.Embedding(cfg.max_source_positions, d)
        self.layers = nn.ModuleList(
            EncoderLayer(d, cfg.encoder_attention_heads, cfg.encoder_ffn_dim)
            for _ in range(cfg.encoder_layers))
        self.layer_norm = LayerNorm(d)
        fddt_kw = dict(is_diagonal=cfg.fddt_is_diagonal,
                       bias_only=cfg.fddt_bias_only,
                       use_silence=cfg.fddt_use_silence,
                       use_target=cfg.fddt_use_target,
                       use_overlap=cfg.fddt_use_overlap,
                       use_non_target=cfg.fddt_use_non_target)
        if cfg.use_fddt and cfg.num_fddts:
            self.fddts = nn.ModuleList(FDDT(d, **fddt_kw)
                                       for _ in range(cfg.num_fddts))
        if cfg.use_fddt and cfg.use_pre_pos_fddt:
            self.initial_fddt = FDDT(d, **fddt_kw)
        if cfg.ctc_weight > 0.0:
            if cfg.additional_layer:
                self.additional_layer = EncoderLayer(
                    d, cfg.encoder_attention_heads, cfg.encoder_ffn_dim)
            if cfg.additional_self_attention_layer:
                self.additional_self_attention_layer = Attention(
                    d, cfg.encoder_attention_heads)
            if cfg.pre_ctc_sub_sample:
                self.subsample_conv1 = nn.Conv1d(d, d, 3, stride=2, padding=1,
                                                 bias=False)
                self.subsample_conv2 = nn.Conv1d(d, d, 3, stride=2, padding=1,
                                                 bias=False)
            self.lm_head = nn.Linear(d, cfg.ctc_vocab_size, bias=False)
        if cfg.use_enrollments and cfg.scb_layers:
            self.ca_enrolls = nn.ModuleList(
                SCB(d, cfg.encoder_attention_heads, cfg.encoder_ffn_dim)
                for _ in range(cfg.scb_layers))

    def stem(self, input_features: torch.Tensor) -> torch.Tensor:
        """(B, n_mels, 3000) -> (B, 1500, D): conv1 + gelu, conv2 (stride 2)
        + gelu (whisper.py:196-222)."""
        dt = self.cfg.compute_dtype
        x = input_features.to(dt)
        x = gelu(F.conv1d(x, self.conv1.weight.to(dt), self.conv1.bias.to(dt),
                          padding=1))
        x = gelu(F.conv1d(x, self.conv2.weight.to(dt), self.conv2.bias.to(dt),
                          stride=2, padding=1))
        return x.transpose(1, 2)

    def forward(self, input_features: torch.Tensor,
                stno_mask: Optional[torch.Tensor] = None,
                enroll_features: Optional[torch.Tensor] = None,
                enroll_stno: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, n_mels, 3000) features, (B, 4, 1500) STNO -> last hidden
        state (B, 1500, D) (dicow.py:104-193). The STNO mask is read only
        by the FDDTs: without them (``use_fddt=False``, pre-training) it
        may be None.

        With ``use_enrollments`` and enrollment features (B, n_mels, 3000) /
        STNO (B, 4, 1500), the sample and the enrollment run as a stream axis
        (B, 2, T, D): the stem over B*2 rows, the FDDTs and the first
        ``scb_layers`` layers over both streams, each of those layers after
        its SCB; the enrollment stream is dropped after the last SCB."""
        cfg = self.cfg
        use_streams = cfg.use_enrollments and enroll_features is not None
        if use_streams and not cfg.scb_layers:
            raise ValueError(
                "enroll_features provided with use_enrollments=True but "
                "scb_layers is 0/None: the enrollment stream would never be "
                "fused or dropped (set scb_layers>0 or omit enrollments)")
        if use_streams:
            feats = torch.stack([input_features, enroll_features], dim=1)
            stno_mask = torch.stack([stno_mask, enroll_stno], dim=1)
            b, s = feats.shape[:2]
            x = self.stem(feats.reshape(b * s, *feats.shape[2:]))
            x = x.reshape(b, s, *x.shape[1:])              # (B, 2, T, D)
        else:
            x = self.stem(input_features)
        if cfg.use_fddt and cfg.use_pre_pos_fddt:
            x = self.initial_fddt(x, stno_mask)
        x = x + self.embed_positions.weight.to(x.dtype)[: x.shape[-2]]
        scb_n = cfg.scb_layers if use_streams else 0
        for i in range(scb_n):
            if cfg.use_fddt and i < cfg.num_fddts:
                x = self.fddts[i](x, stno_mask)
            x = self.ca_enrolls[i](x, cfg.compute_dtype, flash=self.flash)
            if i == scb_n - 1:
                # the enrollment stream is no longer needed
                x, stno_mask = x[:, 0], stno_mask[:, 0]
            x = self.layers[i](x, cfg.compute_dtype, flash=self.flash)
        for i in range(scb_n, len(self.layers)):
            if self.remat and torch.is_grad_enabled():
                x = self._remat_layer(i, x, stno_mask)
            else:
                x = self._layer(i, x, stno_mask)
        return self.layer_norm(x)

    def _remat_layer(self, i: int, x: torch.Tensor,
                     stno_mask: torch.Tensor) -> torch.Tensor:
        """Layer ``i`` with its FDDT, recomputed in the backward pass under
        ``self.remat``: one checkpointed region ('full', 'dots'), or, for
        'attn', two around the attention core, which runs outside them.
        The core's autograd then keeps its q, k, v, output and lse, so the
        backward launches no flash forward (the JAX policy saves the
        core's output, 'attn_out'), at the cost of holding those tensors
        for every layer."""
        if self.remat != "attn":
            return checkpoint(self._layer, i, x, stno_mask,
                              use_reentrant=False,
                              context_fn=remat_context(self.remat))
        x, q, k, v = checkpoint(self._attn_in, i, x, stno_mask,
                                use_reentrant=False)
        out = sdpa(q, k, v, flash=self.flash)
        return checkpoint(self.layers[i].attn_out, x, out,
                          self.cfg.compute_dtype, use_reentrant=False)

    def _attn_in(self, i: int, x: torch.Tensor, stno_mask: torch.Tensor):
        """Layer ``i``'s FDDT, then its attention's inputs: (x, q, k, v)."""
        cfg = self.cfg
        if cfg.use_fddt and i < cfg.num_fddts:
            x = self.fddts[i](x, stno_mask)
        return (x, *self.layers[i].attn_in(x, cfg.compute_dtype))

    def _layer(self, i: int, x: torch.Tensor,
               stno_mask: torch.Tensor) -> torch.Tensor:
        """Layer ``i`` with its FDDT (dicow.py:151-157)."""
        cfg = self.cfg
        if cfg.use_fddt and i < cfg.num_fddts:
            x = self.fddts[i](x, stno_mask)
        return self.layers[i](x, cfg.compute_dtype, flash=self.flash)

    def ctc_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """CTC head over the encoder hidden states (dicow.py:196-212): extra
        layer OR bare self-attention (no residual), then optional 2x
        stride-2 conv subsampling (no activation), then lm_head -> fp32."""
        cfg = self.cfg
        dt = cfg.compute_dtype
        h = hidden.to(dt)
        if cfg.additional_layer and cfg.ctc_weight > 0.0:
            h = self.additional_layer(h, dt, flash=self.flash)
        elif cfg.additional_self_attention_layer and cfg.ctc_weight > 0.0:
            h = self.additional_self_attention_layer(h, h, dt,
                                                     flash=self.flash)
        if cfg.pre_ctc_sub_sample and cfg.ctc_weight > 0.0:
            for conv in (self.subsample_conv1, self.subsample_conv2):
                h = F.conv1d(
                    h.transpose(1, 2), conv.weight.to(dt), stride=2,
                    padding=1).transpose(1, 2)
        return linear(self.lm_head, h, dt).float()


class _Core(nn.Module):
    def __init__(self, encoder: DiCoWEncoder, decoder: WhisperDecoder):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder


class DiCoW(nn.Module):
    """Encoder-decoder with the HF parameter layout (``model.encoder.*``,
    ``model.decoder.*``, ``proj_out`` tied to ``embed_tokens``)."""

    def __init__(self, cfg: DiCoWConfig, flash: bool = False):
        super().__init__()
        self.cfg = cfg
        self.model = _Core(DiCoWEncoder(cfg, flash), WhisperDecoder(cfg))
        self.proj_out = nn.Linear(cfg.d_model, cfg.vocab_size, bias=False)
        self.proj_out.weight = self.model.decoder.embed_tokens.weight

    @property
    def encoder(self) -> DiCoWEncoder:
        return self.model.encoder

    def forward(self, input_features: torch.Tensor, stno_mask: torch.Tensor,
                decoder_input_ids: torch.Tensor,
                enroll_features: Optional[torch.Tensor] = None,
                enroll_stno: Optional[torch.Tensor] = None):
        """Teacher-forced forward (dicow.py:220-238): (B, n_mels, 3000)
        features, (B, 4, 1500) STNO, (B, T) decoder input ids [, SE-DiCoW
        enrollment features and STNO] -> (decoder logits fp32 (B, T, V),
        encoder last hidden (B, 1500, D))."""
        enc = self.encoder(input_features, stno_mask, enroll_features,
                           enroll_stno)
        hidden = self.decoder(decoder_input_ids, enc)
        return self.decoder.lm_logits(hidden), enc

    def set_gradient_checkpointing(self, enabled: bool,
                                   policy: str = "full") -> None:
        """``training.gradient_checkpointing``: recompute every encoder
        layer after the SCB region (with its FDDT) and every decoder layer
        in the backward pass (``torch.utils.checkpoint``, non-reentrant),
        keeping what ``policy`` saves, as the JAX package's
        ``set_remat_policy``: 'full', 'dots' (``whisper.py::remat_context``)
        or 'attn' (``DiCoWEncoder._remat_layer``; the decoder's layers as
        'full'). The JAX package applies the policy only to its scanned
        layers without FDDT and remats its FDDT layers in full
        (dicow.py:162-172); here every checkpointed encoder layer takes it.
        Loss and gradients are the same under every policy; memory and
        time differ."""
        if policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy={policy!r}: one of "
                             f"{REMAT_POLICIES}")
        self.encoder.remat = self.decoder.remat = policy if enabled else None

    @property
    def decoder(self) -> WhisperDecoder:
        return self.model.decoder


def _uniform_(t: torch.Tensor, bound: float, gen: torch.Generator):
    t.uniform_(-bound, bound, generator=gen)


def _init_linear_(m: nn.Linear, gen: torch.Generator) -> None:
    # torch nn.Linear's kaiming-uniform fan-in bound (whisper.py:752-760)
    bound = 1.0 / math.sqrt(m.weight.shape[1])
    _uniform_(m.weight, bound, gen)
    if m.bias is not None:
        _uniform_(m.bias, bound, gen)


def _init_layer_(layer: nn.Module, gen: torch.Generator) -> None:
    for m in layer.modules():
        if isinstance(m, nn.Linear):
            _init_linear_(m, gen)
        elif isinstance(m, LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()


@torch.no_grad()
def init_dicow_(model: DiCoW, generator: torch.Generator) -> DiCoW:
    """Random init with the distributions of the JAX package's init_dicow
    (dicow.py:246-293, whisper.py:748-848, fddt.py:28-76). The numbers
    differ from jax.random's; the tests bridge the JAX weights instead."""
    cfg = model.cfg
    enc, dec = model.encoder, model.decoder
    d = cfg.d_model
    _uniform_(enc.conv1.weight, 1.0 / math.sqrt(cfg.num_mel_bins * 3),
              generator)
    _uniform_(enc.conv1.bias, 1.0 / math.sqrt(cfg.num_mel_bins * 3),
              generator)
    _uniform_(enc.conv2.weight, 1.0 / math.sqrt(d * 3), generator)
    _uniform_(enc.conv2.bias, 1.0 / math.sqrt(d * 3), generator)
    enc.embed_positions.weight.copy_(torch.from_numpy(
        sinusoidal_positions(cfg.max_source_positions, d)))
    for layer in list(enc.layers) + list(dec.layers):
        _init_layer_(layer, generator)
    enc.layer_norm.weight.fill_(1.0)
    enc.layer_norm.bias.zero_()
    dec.embed_tokens.weight.normal_(0.0, 0.02, generator=generator)
    dec.embed_positions.weight.normal_(0.0, 0.02, generator=generator)
    dec.layer_norm.weight.fill_(1.0)
    dec.layer_norm.bias.zero_()
    for f in getattr(enc, "fddts", ()):
        # per-layer FDDTs use non_target_rate=1.0 (dicow.py:259-262)
        f.init_(generator, 1.0, cfg.fddt_init)
    if hasattr(enc, "initial_fddt"):
        enc.initial_fddt.init_(generator, cfg.non_target_fddt_value,
                               cfg.fddt_init)
    for name in ("additional_layer", "additional_self_attention_layer"):
        if hasattr(enc, name):
            _init_layer_(getattr(enc, name), generator)
    for name in ("subsample_conv1", "subsample_conv2"):
        if hasattr(enc, name):
            _uniform_(getattr(enc, name).weight, 1.0 / math.sqrt(d * 3),
                      generator)
    if hasattr(enc, "lm_head"):
        _init_linear_(enc.lm_head, generator)
    for scb in getattr(enc, "ca_enrolls", ()):
        _init_scb_(scb, generator)
    return model


def _init_scb_(scb: SCB, gen: torch.Generator) -> None:
    """init_scb (dicow.py:72-92): the cross-attention as any attention;
    ffn.0 and ffn.3 xavier-uniform with gain 0.1 plus an identity block
    (attention output -> first D hidden units -> output), zero biases; the
    gate zero, so a fresh SCB leaves the sample stream as it is."""
    p = scb.cae
    _init_layer_(p.cross_attn, gen)
    d = p.ffn["3"].weight.shape[0]
    for lin in (p.ffn["0"], p.ffn["3"]):
        d_out, d_in = lin.weight.shape
        _uniform_(lin.weight, 0.1 * math.sqrt(6.0 / (d_in + d_out)), gen)
        lin.bias.zero_()
    eye = torch.eye(d, dtype=p.ffn["0"].weight.dtype,
                    device=p.ffn["0"].weight.device)
    p.ffn["0"].weight[:d, :d] += eye
    p.ffn["3"].weight[:, :d] += eye
    p.cross_gate.gate.zero_()


def build_dicow(cfg: DiCoWConfig, device: torch.device, seed: int = 0,
                flash: bool = False,
                dtype: Optional[torch.dtype] = None) -> DiCoW:
    """Construct on ``device`` and random-initialize from ``seed``."""
    with torch.device(device):
        model = DiCoW(cfg, flash)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    init_dicow_(model, gen)
    if dtype is not None:
        model.to(dtype)
    return model.eval()
