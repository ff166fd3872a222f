"""Plain reference of DiCoW (Whisper large-v3-turbo with FDDT in every
layer and the CTC head) in float32 PyTorch: the encoder over one 30 s
window, the decoder teacher-forced over a whole token sequence, the logits,
and Whisper's timestamp rules. No cache, no batching across windows, no
kernel; it imports torch and numpy only.

The weights are the benchmark's (``make_weights``), made on the device from
the seed in two generator calls and handed to the port under its Hugging
Face parameter names.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

STNO = ("silence", "target", "non_target", "overlap")
NEG = torch.finfo(torch.float32).min


def _attn_names(prefix: str, d: int) -> List[tuple]:
    b = 1.0 / math.sqrt(d)
    return [(f"{prefix}.q_proj.weight", (d, d), ("uniform", b)),
            (f"{prefix}.q_proj.bias", (d,), ("uniform", b)),
            (f"{prefix}.k_proj.weight", (d, d), ("uniform", b)),
            (f"{prefix}.v_proj.weight", (d, d), ("uniform", b)),
            (f"{prefix}.v_proj.bias", (d,), ("uniform", b)),
            (f"{prefix}.out_proj.weight", (d, d), ("uniform", b)),
            (f"{prefix}.out_proj.bias", (d,), ("uniform", b))]


def _norm(prefix: str, d: int) -> List[tuple]:
    # away from the identity, so that the comparison covers them
    return [(f"{prefix}.weight", (d,), ("around", 1.0, 0.1)),
            (f"{prefix}.bias", (d,), ("uniform", 0.02))]


def _layer(prefix: str, d: int, ffn: int, cross: bool) -> List[tuple]:
    out = _attn_names(f"{prefix}.self_attn", d)
    out += _norm(f"{prefix}.self_attn_layer_norm", d)
    if cross:
        out += _attn_names(f"{prefix}.encoder_attn", d)
        out += _norm(f"{prefix}.encoder_attn_layer_norm", d)
    out += [(f"{prefix}.fc1.weight", (ffn, d), ("uniform", 1 / math.sqrt(d))),
            (f"{prefix}.fc1.bias", (ffn,), ("uniform", 1 / math.sqrt(d))),
            (f"{prefix}.fc2.weight", (d, ffn),
             ("uniform", 1 / math.sqrt(ffn))),
            (f"{prefix}.fc2.bias", (d,), ("uniform", 1 / math.sqrt(ffn)))]
    return out + _norm(f"{prefix}.final_layer_norm", d)


def _fddt(prefix: str, d: int, non_target: float) -> List[tuple]:
    # the 'suppressive' values (target and overlap 1, silence and
    # non-target the configured rate) with a spread, and drawn biases
    centre = {"silence": non_target, "target": 1.0,
              "non_target": non_target, "overlap": 1.0}
    out = []
    for c in STNO:
        out += [(f"{prefix}.{c}_linear.weight", (d,),
                 ("around", centre[c], 0.2)),
                (f"{prefix}.{c}_linear.bias", (d,), ("uniform", 0.1))]
    return out


def param_spec(cfg: dict) -> List[tuple]:
    """(name, shape, init) of every parameter of the configuration, under
    the Hugging Face names of DiCoW checkpoints. Inits: ('uniform', b) on
    [-b, b]; ('around', c, s) on c + [-s, s]; ('normal', std);
    ('sinusoid',) Whisper's encoder positions."""
    d, ffn, m = cfg["d_model"], cfg["encoder_ffn_dim"], cfg["num_mel_bins"]
    e = "model.encoder"
    spec = [(f"{e}.conv1.weight", (d, m, 3), ("uniform", 1 / math.sqrt(m * 3))),
            (f"{e}.conv1.bias", (d,), ("uniform", 1 / math.sqrt(m * 3))),
            (f"{e}.conv2.weight", (d, d, 3), ("uniform", 1 / math.sqrt(d * 3))),
            (f"{e}.conv2.bias", (d,), ("uniform", 1 / math.sqrt(d * 3))),
            (f"{e}.embed_positions.weight", (cfg["max_source_positions"], d),
             ("sinusoid",))]
    for i in range(cfg["encoder_layers"]):
        spec += _layer(f"{e}.layers.{i}", d, ffn, False)
    spec += _norm(f"{e}.layer_norm", d)
    for i in range(cfg["encoder_layers"]):
        spec += _fddt(f"{e}.fddts.{i}", d, 1.0)
    spec += _fddt(f"{e}.initial_fddt", d, cfg["non_target_fddt_value"])
    spec += _attn_names(f"{e}.additional_self_attention_layer", d)
    for k in (1, 2):
        spec.append((f"{e}.subsample_conv{k}.weight", (d, d, 3),
                     ("uniform", 1 / math.sqrt(d * 3))))
    spec.append((f"{e}.lm_head.weight", (cfg["vocab_size"] + 1, d),
                 ("uniform", 1 / math.sqrt(d))))
    for i in range(cfg.get("scb_layers") or 0):
        # SE-DiCoW's SCBs, the gate drawn open so that every SCB weight
        # takes part
        c = f"{e}.ca_enrolls.{i}.cae"
        spec += _attn_names(f"{c}.cross_attn", d)
        spec += [(f"{c}.ffn.0.weight", (ffn, 2 * d),
                  ("uniform", 1 / math.sqrt(2 * d))),
                 (f"{c}.ffn.0.bias", (ffn,), ("uniform", 0.02)),
                 (f"{c}.ffn.3.weight", (d, ffn),
                  ("uniform", 1 / math.sqrt(ffn))),
                 (f"{c}.ffn.3.bias", (d,), ("uniform", 0.02)),
                 (f"{c}.cross_gate.gate", (1,), ("around", 0.5, 0.2))]
    dd, dffn = cfg["d_model"], cfg["decoder_ffn_dim"]
    spec += [("model.decoder.embed_tokens.weight", (cfg["vocab_size"], dd),
              ("normal", 0.02)),
             ("model.decoder.embed_positions.weight",
              (cfg["max_target_positions"], dd), ("normal", 0.02))]
    for i in range(cfg["decoder_layers"]):
        spec += _layer(f"model.decoder.layers.{i}", dd, dffn, True)
    spec += _norm("model.decoder.layer_norm", dd)
    return spec


def sinusoids(length: int, d: int) -> torch.Tensor:
    inc = math.log(10000) / (d // 2 - 1)
    inv = torch.exp(-inc * torch.arange(d // 2, dtype=torch.float64))
    t = torch.arange(length, dtype=torch.float64)[:, None] * inv[None]
    return torch.cat([torch.sin(t), torch.cos(t)], dim=1).float()


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The benchmark's weights from ``seed``, float32 on ``device``: one
    uniform and one normal draw of the whole size on a generator of the
    device, cut into views and scaled in place. ``proj_out.weight`` is the
    tied ``embed_tokens``."""
    spec = param_spec(cfg)
    n_uni = sum(math.prod(s) for _, s, i in spec if i[0] != "normal")
    n_nrm = sum(math.prod(s) for _, s, i in spec if i[0] == "normal")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    uni = torch.rand(n_uni, generator=gen, device=device) * 2.0 - 1.0
    nrm = torch.randn(n_nrm, generator=gen, device=device)
    out, ou, on = {}, 0, 0
    for name, shape, init in spec:
        n = math.prod(shape)
        if init[0] == "normal":
            t = nrm[on: on + n].view(shape).mul_(init[1])
            on += n
        else:
            t = uni[ou: ou + n].view(shape)
            ou += n
            if init[0] == "uniform":
                t.mul_(init[1])
            elif init[0] == "around":
                t.mul_(init[2]).add_(init[1])
            else:
                t.copy_(sinusoids(*shape).to(device))
        out[name] = t
    out["proj_out.weight"] = out["model.decoder.embed_tokens.weight"]
    return out


# -- features -----------------------------------------------------------------

N_FFT, HOP, SR, CHUNK = 400, 160, 16000, 480000


def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, np.float64)
    lin = 3.0 * f / 200.0
    return np.where(f >= 1000.0,
                    15.0 + np.log(np.maximum(f, 1000.0) / 1000.0)
                    * 27.0 / np.log(6.4), lin)


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, np.float64)
    return np.where(m >= 15.0,
                    1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)),
                    200.0 * m / 3.0)


def mel_filters(n_mels: int) -> np.ndarray:
    """Slaney-scale, slaney-normalised triangles over 0-8 kHz, (201, n)."""
    pts = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(8000.0),
                                 n_mels + 2))
    fft = np.linspace(0, SR // 2, N_FFT // 2 + 1)
    lo, mid, hi = pts[:-2], pts[1:-1], pts[2:]
    up = (fft[:, None] - lo[None]) / (mid - lo)[None]
    down = (hi[None] - fft[:, None]) / (hi - mid)[None]
    fb = np.maximum(0.0, np.minimum(up, down))
    return fb * (2.0 / (hi - lo))[None]


def log_mel(samples: np.ndarray, n_mels: int, device) -> Tuple[torch.Tensor,
                                                               int]:
    """Whisper's log-mel of a whole recording zero-padded to a multiple of
    30 s (the long-form features): (n_mels, frames) float32, and the valid
    frames (one per 160 samples begun)."""
    n = samples.shape[0]
    padded = np.zeros(int(math.ceil(max(n, 1) / CHUNK)) * CHUNK, np.float32)
    padded[:n] = samples
    x = torch.as_tensor(padded, dtype=torch.float64, device=device)
    win = torch.hann_window(N_FFT, periodic=True, dtype=torch.float64,
                            device=device)
    spec = torch.stft(x, N_FFT, HOP, window=win, center=True,
                      pad_mode="reflect", return_complex=True)[:, :-1]
    power = spec.abs() ** 2
    fb = torch.as_tensor(mel_filters(n_mels), device=device)
    mel = fb.T @ power
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    log_spec = torch.maximum(log_spec, log_spec.max() - 8.0)
    return ((log_spec + 4.0) / 4.0).float(), int(math.ceil(n / HOP))


def stno(turns, target: str, speakers, n_samples: int) -> np.ndarray:
    """(4, frames at 50 Hz) silence / target / non-target / overlap of one
    target speaker, from the speakers' turns (speaker, start s, duration s,
    text): activity per sample over the recording padded to 30 s, averaged
    over 320 samples."""
    act = np.zeros((len(speakers), int(math.ceil(n_samples / CHUNK)) * CHUNK),
                   np.float64)
    idx = {s: i for i, s in enumerate(speakers)}
    for spk, start, dur, _ in turns:
        a = max(0, int(round(start * SR)))
        b = min(n_samples, int(round((start + dur) * SR)))
        if b > a:
            act[idx[spk], a:b] = 1.0
    m = act.reshape(len(speakers), -1, 2 * HOP).mean(-1)
    tgt = idx[target]
    others = np.prod(np.delete(1.0 - m, tgt, axis=0), axis=0)
    sil = np.prod(1.0 - m, axis=0)
    target_only = m[tgt] * others
    non_target = (1.0 - m[tgt]) * (1.0 - others)
    return np.stack([sil, target_only, non_target, m[tgt] - target_only])


def window(features: torch.Tensor, valid_frames: int, stno_mask: np.ndarray,
           seek: int, nsf: int = 3000):
    """The seek window at mel frame ``seek``: (n_mels, nsf) features zeroed
    past the recording's end, (4, nsf / 2) STNO with silence there."""
    feats = torch.zeros(features.shape[0], nsf, device=features.device)
    n = max(0, min(valid_frames - seek, nsf))
    feats[:, :n] = features[:, seek: seek + n]
    ns = max(0, min(valid_frames // 2 - seek // 2, nsf // 2))
    st = np.zeros((4, nsf // 2), np.float32)
    st[0] = 1.0
    st[:, :ns] = stno_mask[:, seek // 2: seek // 2 + ns]
    return feats, torch.as_tensor(st, device=features.device)


# -- the model --------------------------------------------------------------

Matmul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


class Reference:
    """Float32 forward of DiCoW from a weight dict. ``mm`` is every matrix
    product (a @ b); the control passes one that rounds its operands."""

    def __init__(self, cfg: dict, w: Dict[str, torch.Tensor],
                 mm: Matmul = exact, remat: bool = False):
        self.cfg, self.w, self.mm, self.remat = cfg, w, mm, remat

    def lin(self, x, name, bias=True):
        y = self.mm(x, self.w[f"{name}.weight"].T)
        b = self.w.get(f"{name}.bias") if bias else None
        return y if b is None else y + b

    def ln(self, x, name):
        return F.layer_norm(x, (x.shape[-1],), self.w[f"{name}.weight"],
                            self.w[f"{name}.bias"], 1e-5)

    def conv(self, x, name, stride, bias=True):
        """1-d convolution of (C, T) with kernel 3, padding 1, as a product
        over the three taps."""
        wt = self.w[f"{name}.weight"]                      # (O, C, 3)
        xp = F.pad(x, (1, 1))
        t_out = (x.shape[-1] + 2 - 3) // stride + 1
        cols = torch.stack([xp[:, k: k + stride * (t_out - 1) + 1: stride]
                            for k in range(3)], dim=1)     # (C, 3, T_out)
        y = self.mm(wt.reshape(wt.shape[0], -1),
                    cols.reshape(-1, t_out))
        if bias:
            y = y + self.w[f"{name}.bias"][:, None]
        return y

    def attention(self, xq, xkv, name, heads, mask=None):
        h = heads
        d = xq.shape[-1]
        hd = d // h
        q = (self.lin(xq, f"{name}.q_proj") * hd ** -0.5)
        k = self.lin(xkv, f"{name}.k_proj", bias=False)
        v = self.lin(xkv, f"{name}.v_proj")
        q, k, v = (t.reshape(t.shape[0], h, hd).transpose(0, 1)
                   for t in (q, k, v))
        s = self.mm(q, k.transpose(-1, -2))
        if mask is not None:
            s = s.masked_fill(~mask, NEG)
        o = self.mm(torch.softmax(s, dim=-1), v)
        return self.lin(o.transpose(0, 1).reshape(-1, d), f"{name}.out_proj")

    def mlp(self, x, name):
        return self.lin(F.gelu(self.lin(x, f"{name}.fc1")), f"{name}.fc2")

    def fddt(self, x, st, name):
        """Diagonal FDDT: x * (m @ W) + m @ B, m the (T, 4) STNO."""
        m = st.T
        scale = m @ torch.stack([self.w[f"{name}.{c}_linear.weight"]
                                 for c in STNO])
        shift = m @ torch.stack([self.w[f"{name}.{c}_linear.bias"]
                                 for c in STNO])
        return x * scale + shift

    def layer(self, x, i):
        """Encoder layer ``i`` (its FDDT applied before); recomputed in the
        backward pass with ``remat``, which holds one layer's activations
        at a time."""
        if self.remat and torch.is_grad_enabled():
            return checkpoint(self._layer, x, i, use_reentrant=False)
        return self._layer(x, i)

    def _layer(self, x, i):
        p = f"model.encoder.layers.{i}"
        h = self.ln(x, f"{p}.self_attn_layer_norm")
        x = x + self.attention(h, h, f"{p}.self_attn",
                               self.cfg["encoder_attention_heads"])
        return x + self.mlp(self.ln(x, f"{p}.final_layer_norm"), p)

    def scb(self, x, enr, i):
        """SE-DiCoW's SCB ``i``: the sample attends to the enrollment; a
        tanh-gated MLP of [attention; sample] is added to the sample."""
        c = f"model.encoder.ca_enrolls.{i}.cae"
        a = self.attention(x, enr, f"{c}.cross_attn",
                           self.cfg["encoder_attention_heads"])
        h = self.lin(F.gelu(self.lin(torch.cat([a, x], -1), f"{c}.ffn.0")),
                     f"{c}.ffn.3")
        return x + torch.tanh(self.w[f"{c}.cross_gate.gate"]) * h

    def stem(self, feats, st):
        e = "model.encoder"
        x = F.gelu(self.conv(feats, f"{e}.conv1", 1))
        x = F.gelu(self.conv(x, f"{e}.conv2", 2)).T
        x = self.fddt(x, st, f"{e}.initial_fddt")
        return x + self.w[f"{e}.embed_positions.weight"][: x.shape[0]]

    def encoder(self, feats: torch.Tensor, st: torch.Tensor,
                enroll: Optional[torch.Tensor] = None,
                enroll_st: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(n_mels, 3000) features and (4, 1500) STNO -> (1500, d). With
        an enrollment window (SE-DiCoW), both streams run the stem and the
        first ``scb_layers`` layers, each layer after its SCB; the
        enrollment stream ends after the last SCB."""
        x = self.stem(feats, st)
        first = 0
        if enroll is not None and self.cfg.get("scb_layers"):
            enr = self.stem(enroll, enroll_st)
            first = self.cfg["scb_layers"]
            for i in range(first):
                x = self.fddt(x, st, f"model.encoder.fddts.{i}")
                enr = self.fddt(enr, enroll_st, f"model.encoder.fddts.{i}")
                x = self.layer(self.scb(x, enr, i), i)
                if i < first - 1:
                    enr = self.layer(enr, i)
        for i in range(first, self.cfg["encoder_layers"]):
            x = self.layer(self.fddt(x, st, f"model.encoder.fddts.{i}"), i)
        return self.ln(x, "model.encoder.layer_norm")

    def decoder_logits(self, tokens: torch.Tensor,
                       enc: torch.Tensor) -> torch.Tensor:
        """(L,) tokens over (1500, d) encoder states -> (L, V) logits."""
        dd = "model.decoder"
        emb = self.w[f"{dd}.embed_tokens.weight"]
        t = tokens.shape[0]
        x = emb[tokens] + self.w[f"{dd}.embed_positions.weight"][:t]
        causal = torch.ones(t, t, dtype=torch.bool,
                            device=x.device).tril()
        heads = self.cfg["decoder_attention_heads"]
        for i in range(self.cfg["decoder_layers"]):
            p = f"{dd}.layers.{i}"
            h = self.ln(x, f"{p}.self_attn_layer_norm")
            x = x + self.attention(h, h, f"{p}.self_attn", heads, causal)
            h = self.ln(x, f"{p}.encoder_attn_layer_norm")
            x = x + self.attention(h, enc, f"{p}.encoder_attn", heads)
            x = x + self.mlp(self.ln(x, f"{p}.final_layer_norm"), p)
        x = self.ln(x, f"{dd}.layer_norm")
        return self.mm(x, emb.T)


def fp8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The control's product: both operands rounded to float8 e4m3 with a
    per-tensor scale (amax to 448), then multiplied in float32."""
    def q(x):
        s = x.abs().amax().clamp(min=1e-12) / 448.0
        return (x / s).to(torch.float8_e4m3fn).float() * s
    return q(a) @ q(b)


# -- Whisper's decoding rules ---------------------------------------------------

def allowed_mask(logits: torch.Tensor, tokens: torch.Tensor, prompt: int,
                 tok: dict, suppress: torch.Tensor) -> torch.Tensor:
    """(L, V) logits of a teacher-forced pass over ``tokens`` -> (n, V)
    bool: what Whisper's rules leave open at each of the n generated
    positions (the suppressed ids; no-timestamps; after a timestamp pair
    text only, after a lone timestamp timestamps or end of text only;
    timestamps never decrease; the first token a timestamp; text closed
    where the timestamps' total probability beats every text token). The
    end-of-text score is as the suppression leaves it."""
    v = logits.shape[1]
    ts, eos = tok["timestamp_begin"], tok["eos"]
    ids = torch.arange(v, device=logits.device)
    rows = []
    for j in range(prompt, tokens.shape[0]):
        k = j - prompt
        seq = tokens[prompt:j]
        ok = torch.ones(v, dtype=torch.bool, device=logits.device)
        ok[suppress] = False
        ok[tok["no_timestamps"]] = False
        last_ts = k >= 1 and bool(seq[-1] >= ts)
        pen_ts = k < 2 or bool(seq[-2] >= ts)
        if last_ts and pen_ts:
            ok &= ids < ts
        elif last_ts:
            ok &= ids >= eos
        stamps = seq[seq >= ts]
        if stamps.numel():
            floor = int(stamps[-1]) + (0 if last_ts and not pen_ts else 1)
            ok &= ~((ids >= ts) & (ids < floor))
        if k == 0:
            ok &= ids >= ts
        s = logits[j - 1].masked_fill(~ok, NEG)
        lp = torch.log_softmax(s.double(), dim=-1)
        if torch.logsumexp(lp[ts:], 0) > lp[:ts].max():
            ok &= ids >= ts
        if k == 0 and eos not in suppress.tolist():
            ok[eos] = True
        rows.append(ok)
    return torch.stack(rows)


def served_gaps(logits: torch.Tensor, tokens: torch.Tensor, prompt: int,
                allowed: torch.Tensor) -> torch.Tensor:
    """How far each generated token's reference logit lies below the best
    open one (inf where the token was not open)."""
    pred = logits[prompt - 1: tokens.shape[0] - 1]
    best = pred.masked_fill(~allowed, -math.inf).amax(-1)
    got = pred.gather(1, tokens[prompt:, None])[:, 0]
    ok = allowed.gather(1, tokens[prompt:, None])[:, 0]
    return torch.where(ok, best - got, torch.full_like(got, math.inf))


def control_gaps(ref_logits: torch.Tensor, low_logits: torch.Tensor,
                 tokens: torch.Tensor, prompt: int,
                 allowed: torch.Tensor) -> torch.Tensor:
    """At each generated position of the same tokens, how far the token that
    the lower precision puts first lies below the reference's best."""
    pred = ref_logits[prompt - 1: tokens.shape[0] - 1]
    low = low_logits[prompt - 1: tokens.shape[0] - 1]
    best = pred.masked_fill(~allowed, -math.inf).amax(-1)
    pick = low.masked_fill(~allowed, -math.inf).argmax(-1)
    return best - pred.gather(1, pick[:, None])[:, 0]
