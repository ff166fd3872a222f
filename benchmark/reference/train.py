"""Plain float32 reference of the DiCoW fine-tune step: the teacher-forced
forward of ``reference/dicow.py`` with the CTC head, the joint loss
(timestamp-smoothed, case-invariant decoder cross-entropy and CTC), the
gradients by autograd, a global-norm clip and AdamW, over the rows of a
micro-batch in blocks so that the activations of one block at a time are
held. It imports torch and numpy only."""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.dicow import Reference, exact, make_weights

PREHEAT = ("model.encoder.additional_layer.",
           "model.encoder.additional_self_attention_layer.",
           "model.encoder.lm_head.", "model.encoder.subsample_conv1.",
           "model.encoder.subsample_conv2.", "model.encoder.fddts.",
           "model.encoder.initial_fddt.", "model.encoder.ca_enrolls.")
SIGMA = 0.08          # s: the spread of the timestamp targets
N_STAMPS = 1501


def group_of(name: str, frozen_keywords: Sequence[str]) -> str:
    """'preheat' (FDDTs and CTC head), 'frozen' or 'base'."""
    if name.startswith(PREHEAT):
        return "preheat"
    if any(k in name for k in frozen_keywords):
        return "frozen"
    return "base"


def stamp_targets(device) -> torch.Tensor:
    """(1501, 1501) Gaussian over the timestamp times, rows summing to 1."""
    t = 0.02 * torch.arange(N_STAMPS, dtype=torch.float64)
    w = torch.exp(-(t[:, None] - t[None]) ** 2 / (2 * SIGMA ** 2))
    return (w / w.sum(1, keepdim=True)).float().to(device)


def ctc_logits(r: Reference, hidden: torch.Tensor) -> torch.Tensor:
    """The CTC head: a bare self-attention (no norm, no residual), two
    stride-2 convolutions without bias, the vocabulary (+ blank)
    projection."""
    e = "model.encoder"
    h = r.attention(hidden, hidden, f"{e}.additional_self_attention_layer",
                    r.cfg["encoder_attention_heads"])
    h = r.conv(h.T, f"{e}.subsample_conv1", 2, bias=False)
    h = r.conv(h, f"{e}.subsample_conv2", 2, bias=False).T
    return r.mm(h, r.w[f"{e}.lm_head.weight"].T)


def row_losses(r: Reference, feats, stno, labels, upp, cfg: dict,
               prefix: int, stamps: torch.Tensor, enroll=None,
               enroll_st=None):
    """One row: (CE token-loss sum, CE tokens, CTC loss over its target
    length); SE-DiCoW's enrollment window with it where given."""
    tok = cfg["tokens"]
    ts, v = tok["timestamp_begin"], cfg["vocab_size"]
    enc = r.encoder(feats, stno, enroll, enroll_st)
    dec_in = torch.roll(labels, 1)
    dec_in[0] = tok["sot"]
    dec_in = torch.where(dec_in == -100, tok["eos"], dec_in)
    logp = torch.log_softmax(r.decoder_logits(dec_in, enc), -1)

    def token_loss(lab):
        hard = -logp.gather(1, lab.clamp_min(0)[:, None])[:, 0]
        idx = (lab - ts).clamp(0, N_STAMPS - 1)
        soft = -(stamps[idx] * logp[:, ts:]).sum(-1)
        return torch.where(lab >= ts, soft, hard)

    mask = labels != -100
    ce = torch.minimum(token_loss(labels), token_loss(upp))
    ce_sum = (ce * mask).sum()
    keep = labels[prefix:]
    first_task = v - 30 * 50 - 1 - 6
    keep = keep[(keep >= 0) & (keep != tok["eos"]) & (keep < first_task)]
    lp = torch.log_softmax(ctc_logits(r, enc), -1)
    nll = F.ctc_loss(lp[:, None], keep[None], torch.tensor([lp.shape[0]]),
                     torch.tensor([keep.numel()]), blank=v,
                     reduction="sum", zero_infinity=True)
    return ce_sum, mask.sum(), nll / max(keep.numel(), 1)


class ReferenceTrainer:
    """Float32 (or, with ``mm``, a lower-precision control) fine-tune from
    the benchmark's weights for ``seed``."""

    def __init__(self, cfg: dict, train: dict, seed: int, device,
                 mm=None, remat: bool = False):
        self.cfg, self.train, self.device = cfg, train, device
        w = make_weights(cfg, seed, device)
        frozen = train["frozen_keywords"]
        self.groups = {}
        self.w = {}
        for name, t in w.items():
            if name == "proj_out.weight":
                continue
            g = group_of(name, frozen)
            leaf = t.clone()
            leaf.requires_grad_(g != "frozen")
            self.w[name] = leaf
            self.groups[name] = g
        self.w["proj_out.weight"] = self.w["model.decoder.embed_tokens.weight"]
        self.trained = [n for n, g in self.groups.items() if g != "frozen"]
        self.start = {n: self.w[n].detach().clone() for n in self.trained}
        self.r = Reference(cfg, self.w, mm or exact, remat)
        self.mu = {n: torch.zeros_like(self.w[n]) for n in self.trained}
        self.nu = {n: torch.zeros_like(self.w[n]) for n in self.trained}
        self.count = 0
        self.stamps = stamp_targets(device)

    def lr(self, group: str) -> float:
        t = self.train
        base = t["learning_rate"] * (t["fddt_lr_multiplier"]
                                     if group == "preheat" else 1.0)
        steps = max(t["max_steps"] - t["warmup_steps"], 1)
        c = self.count - t["warmup_steps"]
        if c < 0:
            return base * self.count / max(t["warmup_steps"], 1)
        c = min(c, steps)
        return base * 0.5 * (1 + math.cos(math.pi * c / steps))

    def _grads(self, batch: Dict[str, np.ndarray], block: int,
               backward: bool = True) -> dict:
        """Gradients of one micro-batch's loss into ``.grad``, its rows in
        blocks; returns its loss parts (``backward`` false: the parts
        alone)."""
        cfg, t = self.cfg, self.train
        dev = self.device
        labels = torch.as_tensor(batch["labels"]).long().to(dev)
        upp = torch.as_tensor(batch["upp_labels"]).long().to(dev)
        feats = torch.as_tensor(batch["input_features"]).float().to(dev)
        stno = torch.as_tensor(batch["stno_mask"]).float().to(dev)
        enroll = enroll_st = None
        if "enroll_features" in batch:
            enroll = torch.as_tensor(batch["enroll_features"]).float().to(dev)
            enroll_st = torch.as_tensor(batch["enroll_stno"]).float().to(dev)
        b = labels.shape[0]
        n_tok = float((labels != -100).sum())
        w_ctc = cfg["ctc_weight"]
        for n in self.trained:
            self.w[n].grad = None
        ce_tot = ctc_tot = 0.0
        for i0 in range(0, b, block):
            ce_sum = ctc_sum = 0.0
            with torch.enable_grad() if backward else torch.no_grad():
                for i in range(i0, min(b, i0 + block)):
                    ce, _, ctc = row_losses(
                        self.r, feats[i], stno[i], labels[i], upp[i], cfg,
                        t["num_prefix_tokens"], self.stamps,
                        None if enroll is None else enroll[i],
                        None if enroll is None else enroll_st[i])
                    ce_sum = ce_sum + ce
                    ctc_sum = ctc_sum + ctc
                loss = (1 - w_ctc) * ce_sum / n_tok + w_ctc * ctc_sum / b
            if backward:
                loss.backward()
            ce_tot += float(ce_sum.detach()) / n_tok
            ctc_tot += float(ctc_sum.detach()) / b
        return {"loss": (1 - w_ctc) * ce_tot + w_ctc * ctc_tot,
                "dec_loss": ce_tot, "ctc_loss": ctc_tot}

    def update(self, batches: List[Dict[str, np.ndarray]],
               block: int = 1) -> dict:
        """One update on the micro-batches of an accumulation (host arrays
        as the port's collator gave them): each micro-batch's gradient of
        its own loss, their mean, the clip, AdamW. Returns each micro-
        batch's loss parts (``parts``) and the clipped gradient's norm per
        trained leaf."""
        t = self.train
        acc: Dict[str, torch.Tensor] = {}
        losses = []
        for k, batch in enumerate(batches):
            losses.append(self._grads(batch, block))
            for n in self.trained:
                g = self.w[n].grad.detach().float()
                acc[n] = g if k == 0 else acc[n] + (g - acc[n]) / (k + 1)
        raw = {n: float(g.norm()) for n, g in acc.items()}
        grads = acc
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        if not bool(norm < t["max_grad_norm"]):
            grads = {n: g / norm * t["max_grad_norm"]
                     for n, g in grads.items()}
        b1, b2, eps = t["adam_beta1"], t["adam_beta2"], t["adam_epsilon"]
        f32 = torch.float32
        bc1 = float(1 - torch.tensor(b1, dtype=f32) ** (self.count + 1))
        bc2 = float(1 - torch.tensor(b2, dtype=f32) ** (self.count + 1))
        with torch.no_grad():
            for n in self.trained:
                g = grads[n]
                self.mu[n] = (1 - b1) * g + b1 * self.mu[n]
                self.nu[n] = (1 - b2) * g * g + b2 * self.nu[n]
                upd = (self.mu[n] / bc1) / (torch.sqrt(self.nu[n] / bc2)
                                            + eps)
                lr = float(torch.tensor(self.lr(self.groups[n]), dtype=f32))
                self.w[n].add_(-lr * upd)
        self.count += 1
        return {"parts": losses,
                "grad_norms": {n: float(g.norm()) for n, g in grads.items()},
                "raw_grad_norms": raw}

    def losses(self, batches: List[Dict[str, np.ndarray]],
               block: int = 1) -> List[dict]:
        """Each micro-batch's loss parts at the parameters as they stand,
        with no update."""
        return [self._grads(batch, block, backward=False)
                for batch in batches]

    def change_norms(self) -> Dict[str, float]:
        return {n: float((self.w[n].detach() - self.start[n]).norm())
                for n in self.trained}


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
               names: List[str]) -> tuple:
    """(gap, leaf): the largest |prog - ref| over max(ref, median ref) of
    the leaves named."""
    med = float(np.median([ref[n] for n in names])) if names else 0.0
    worst, leaf = 0.0, None
    for n in names:
        gap = abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
        if gap > worst:
            worst, leaf = gap, n
    return worst, leaf
