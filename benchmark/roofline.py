"""Peaks of one NVIDIA H100 SXM and the operation and byte counts that the
roofline shares and the MFU readings divide by.

The peaks are NVIDIA's data sheet (dense rates, 700 W). A kernel's bound is
the larger of its operations over the peak rate for their type and its
bytes over the memory rate, counted from the shapes of each launch: every
input byte read once, every output byte written once, the work the inputs
need (the arithmetic of ``chip_smoke.py::bound`` and of its kernel checks).
"""

from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12,
              "tf32": 495e12, "fp8": 1979e12}
PEAK_BYTES = 3.35e12
# the MFU denominator: the dense bf16 tensor-core rate
MFU_PEAK = PEAK_FLOPS["bfloat16"]


def bound_s(flop: float, nbytes: float, dtype: str = "bfloat16") -> float:
    """The least time in seconds the card could take for this work."""
    return max(flop / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)


def bound_by(flop: float, nbytes: float, dtype: str = "bfloat16") -> str:
    return ("operations" if flop / PEAK_FLOPS[dtype] >= nbytes / PEAK_BYTES
            else "bytes")


# -- kernels: (operations, bytes) of one launch ------------------------------

def flash_fwd(bh: int, t: int, d: int, item: int) -> tuple:
    """Encoder flash attention forward over ``bh`` (batch x heads) rows of
    length ``t``: q.k^T and p.v, 2 * 2 * t * t * d each row; q, k, v read,
    out written."""
    return 4.0 * bh * t * t * d, 4.0 * bh * t * d * item


def flash_bwd(bh: int, t: int, d: int, item: int) -> tuple:
    """Flash attention backward without recomputation counted twice: s =
    q.k^T again, dp = g.v^T, dv = p^T.g, dq = ds.k, dk = ds^T.q, 2 * t * t *
    d each; q, k, v, out, g read with the fp32 row lse, dq, dk, dv
    written."""
    return (10.0 * bh * t * t * d,
            8.0 * bh * t * d * item + 4.0 * bh * t)


def ancestry(bb: int, h: int, pos: int, hd: int, item: int) -> tuple:
    """Beam self-attention over an append-only cache: the cache rows before
    ``pos`` read once (k and v), the new k/v, q and out, the (bb, pos)
    ancestor map."""
    nbytes = (2.0 * bb * h * pos * hd * item + 4.0 * bb * h * hd * item
              + 4.0 * bb * pos)
    return 4.0 * bb * h * (pos + 1) * hd, nbytes


def psi_gather(n_ids: int, ctc_t: int, item: int, w_numel: int) -> tuple:
    """CTC prefix psi: the gathered candidate rows of the posterior, each
    read once, the weights and the sums."""
    return (2.0 * n_ids * ctc_t,
            n_ids * ctc_t * item + 4.0 * w_numel + 4.0 * n_ids)


# -- model FLOPs (matrix products only, no recomputation) ---------------------

def encoder_layer_flops(t: int, d: int, ffn: int) -> float:
    """One pre-norm transformer layer over t positions: q, k, v, out
    projections, q.k^T and p.v, and the MLP."""
    return 8.0 * t * d * d + 4.0 * t * t * d + 4.0 * t * d * ffn


def encoder_window_flops(cfg: dict) -> float:
    """The DiCoW encoder over one 30 s window: the conv stem (128 -> d at
    3000 frames, d -> d stride 2), every layer, and with enrollment the
    second stream through the first ``scb_layers`` layers and the SCBs
    (cross-attention, the 2d -> ffn -> d MLP)."""
    n_mels, d, ffn = cfg["num_mel_bins"], cfg["d_model"], cfg["encoder_ffn_dim"]
    t = cfg["max_source_positions"]
    stem = 2.0 * (2 * t) * d * n_mels * 3 + 2.0 * t * d * d * 3
    layers = cfg["encoder_layers"] * encoder_layer_flops(t, d, ffn)
    scb = cfg.get("scb_layers") or 0
    if scb:
        stem *= 2
        layers += scb * encoder_layer_flops(t, d, ffn)
        layers += scb * (8.0 * t * d * d + 4.0 * t * t * d
                         + 2.0 * t * (2 * d) * ffn + 2.0 * t * ffn * d)
    return stem + layers


def ctc_head_flops(cfg: dict) -> float:
    """The CTC head over one window's hidden states: the extra self-
    attention (no MLP), the two stride-2 convolutions, the vocabulary
    projection at a quarter of the frames."""
    d, t = cfg["d_model"], cfg["max_source_positions"]
    attn = 8.0 * t * d * d + 4.0 * t * t * d
    convs = 2.0 * (t // 2) * d * d * 3 + 2.0 * (t // 4) * d * d * 3
    head = 2.0 * (t // 4) * d * (cfg["vocab_size"] + 1)
    return attn + convs + head


def cross_kv_flops(cfg: dict) -> float:
    """The decoder's cross-attention k and v of every layer, once a
    window."""
    d, t = cfg["d_model"], cfg["max_source_positions"]
    return cfg["decoder_layers"] * 2 * 2.0 * t * d * d


def decoder_token_flops(cfg: dict, pos: int) -> float:
    """One decoder position with ``pos`` earlier positions: self-attention
    projections and scores, cross-attention q/out and scores over the
    encoder frames, the MLP, the tied vocabulary projection."""
    d, ffn, t = cfg["d_model"], cfg["decoder_ffn_dim"], \
        cfg["max_source_positions"]
    per_layer = (8.0 * d * d + 4.0 * (pos + 1) * d
                 + 4.0 * d * d + 4.0 * t * d + 4.0 * d * ffn)
    return cfg["decoder_layers"] * per_layer + 2.0 * d * cfg["vocab_size"]
