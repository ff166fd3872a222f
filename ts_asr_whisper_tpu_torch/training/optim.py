"""Optimizer of the port: one global-norm clip, then AdamW in two learning-
rate groups, and the FDDT-preheat freeze schedule.

Counterpart of ts_asr_whisper_tpu/training/optim.py:34-122, written out as
optax computes it so that the same gradients give the same parameters:

- three labels per parameter: 'preheat' (under ``prefixes_to_preheat``,
  lr * ``fddt_lr_multiplier``), 'base' (lr) and 'frozen'; with
  ``preheat_only`` everything outside the preheat group is frozen. Names
  are ``named_parameters()`` names brought to the JAX package's path form
  by ``_normalize_prefix`` (``model.encoder.fddts.0.x`` ->
  ``encoder/fddts/0/x``); LoRA adapters are 'frozen' in the preheat phase
  and 'base' after it. A frozen parameter gets ``requires_grad_(False)``
  and no optimizer state (optax's ``set_to_zero``);
- ``optax.clip_by_global_norm``: when the global norm g of every trainable
  gradient is not below ``max_grad_norm``, each gradient becomes
  (grad / g) * max_grad_norm (``clip_grad_norm_`` would add 1e-6 to g);
- ``optax.adamw``: scale_by_adam (first moment stored in ``adam_mu_dtype``),
  add_decayed_weights, then -lr(count) from ``make_lr_schedule``; one
  update count shared by both groups;
- ``optax.MultiSteps`` for gradient accumulation: a running mean of the k
  micro-batch gradients, and one inner update every k-th micro-batch.

For CUDA parameters the clip and the update of every leaf are one
hand-written kernel launch (``ops/multi_tensor.py``, ``adamw_multi``) that
keeps this arithmetic operation by operation; the loop below is the CPU path
and the kernel's reference. Either path takes the global norm from the
caller when it has computed it (``step(grads, g_norm)``), so an update
computes it once.

Under FSDP2 (``training.shard_params``) each rank steps on its shards of the
parameters and gradients as plain tensors, with the same arithmetic; the
clip reads the norm of the whole gradient, its squared sum added over the
ranks in one all-reduce (``global_norm(..., group)``). Under tensor
parallelism each rank steps on its slices the same way; the clip's norm adds
the squares of the sliced tensors over the ``model`` group and counts the
whole ones once (``global_norm(..., sharded, tp_group)``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..config import TrainingConfig
from ..kernels import route
from ..parallel.mesh import local
from ..parallel.tensor import tp_dim
from ..utils.observability import global_norm, span

LABELS = ("preheat", "base")  # the labels that train


def _normalize_prefix(prefix: str) -> str:
    # accept both the 'encoder/fddts' and the 'model.encoder.fddts' forms
    return prefix.removeprefix("model.").replace(".", "/")


def path_matches(path: str, prefixes: Iterable[str]) -> bool:
    return any(path.startswith(_normalize_prefix(p)) for p in prefixes)


def path_contains(path: str, keywords: Iterable[str]) -> bool:
    return any(k in path for k in keywords)


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    # optax.linear_schedule
    def schedule(count: int) -> float:
        frac = 1 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end
    return schedule


def make_lr_schedule(cfg: TrainingConfig, base_lr: Optional[float] = None
                     ) -> Callable[[int], float]:
    """Linear warmup over ``warmup_steps`` joined to a cosine, linear or
    constant decay over the rest of ``max_steps`` (optax.join_schedules)."""
    lr = base_lr if base_lr is not None else cfg.learning_rate
    warmup = _linear(0.0, lr, max(cfg.warmup_steps, 1))
    steps_after = max(cfg.max_steps - cfg.warmup_steps, 1)
    if cfg.lr_scheduler_type == "cosine":
        def decay(count: int) -> float:  # optax.cosine_decay_schedule
            count = min(count, steps_after)
            return lr * 0.5 * (1 + math.cos(math.pi * count / steps_after))
    elif cfg.lr_scheduler_type == "constant":
        def decay(count: int) -> float:
            return lr
    else:  # linear (HF default)
        decay = _linear(lr, 0.0, steps_after)
    boundary = cfg.warmup_steps

    def schedule(count: int) -> float:
        return warmup(count) if count < boundary else decay(count - boundary)
    return schedule


def param_label(path: str, prefixes_to_preheat: Sequence[str],
                frozen_keywords: Sequence[str], preheat_only: bool) -> str:
    """optim.py:71-80. A LoRA adapter (training/lora.py: ``.../lora_A``,
    ``.../lora_B``; the JAX package's ``lora/...``) trains outside the
    preheat phase whatever the keywords: they freeze the dense weights it
    wraps."""
    if path.endswith(("/lora_A", "/lora_B")):
        return "frozen" if preheat_only else "base"
    if path_matches(path, prefixes_to_preheat):
        return "preheat"
    if preheat_only or path_contains(path, frozen_keywords):
        return "frozen"
    return "base"


def param_labels(model: nn.Module, prefixes_to_preheat: Sequence[str],
                 frozen_keywords: Sequence[str], preheat_only: bool
                 ) -> Dict[str, str]:
    """``named_parameters()`` name -> 'preheat' | 'base' | 'frozen'."""
    return {name: param_label(_normalize_prefix(name), prefixes_to_preheat,
                              frozen_keywords, preheat_only)
            for name, _ in model.named_parameters()}


def trainable_mask(model: nn.Module, prefixes_to_preheat: Sequence[str],
                   frozen_keywords: Sequence[str], preheat_only: bool
                   ) -> Dict[str, bool]:
    """Which parameters receive gradients in this phase."""
    return {name: label != "frozen" for name, label in param_labels(
        model, prefixes_to_preheat, frozen_keywords, preheat_only).items()}


class AdamW:
    """clip_by_global_norm + optax.adamw per label, over the parameters of
    ``groups`` (label -> list of parameters). ``step(grads)`` takes one
    gradient per parameter, in the order of ``params``: this rank's shard
    of it when the parameters are sharded over ``group``. ``sharded``
    flags the parameters sliced over ``tp_group`` (tensor parallelism).
    The second moment is kept in fp32 (what the loop's fp32 arithmetic
    stores after the first update). For CUDA parameters ``table`` holds the
    kernel's table of the leaves; the moments then stay at their addresses
    and are updated in place."""

    def __init__(self, groups: Dict[str, List[nn.Parameter]],
                 cfg: TrainingConfig, lr_multiplier: float, group=None,
                 sharded: Optional[Dict[int, bool]] = None, tp_group=None):
        self.cfg = cfg
        self.groups = groups
        self.group = group
        self.tp_group = tp_group
        self.params = [p for label in LABELS for p in groups.get(label, ())]
        self.sharded = [bool(sharded and sharded.get(id(p)))
                        for p in self.params]
        # what the update writes: the parameters, or this rank's shards
        self.local = [local(p) for p in self.params]
        self.schedules = {
            "preheat": make_lr_schedule(cfg, cfg.learning_rate
                                        * lr_multiplier),
            "base": make_lr_schedule(cfg, cfg.learning_rate)}
        mu_dtype = getattr(torch, cfg.adam_mu_dtype) if cfg.adam_mu_dtype \
            else None
        self.mu = [torch.zeros_like(p, dtype=mu_dtype or p.dtype)
                   for p in self.local]
        self.nu = [torch.zeros_like(p, dtype=torch.float32)
                   for p in self.local]
        self.count = 0
        self.table = None
        if self.local and route(self.local[0], "AdamW") == "kernel":
            from ..ops.multi_tensor import AdamWTable

            self.table = AdamWTable(
                self.local, self.mu, self.nu,
                [k for k, label in enumerate(LABELS)
                 for _ in groups.get(label, ())])

    @torch.no_grad()
    def step(self, grads: Sequence[Optional[torch.Tensor]],
             g_norm: Optional[torch.Tensor] = None) -> None:
        """One update. ``grads``: one per parameter, None read as a zero
        gradient. ``g_norm``: their global norm where the caller has it
        (``global_norm`` over the same gradients, ``group``, ``sharded``
        and ``tp_group``), else computed here. On the card nothing here
        waits for it."""
        with span("train.optimizer"):
            cfg = self.cfg
            if g_norm is None:
                g_norm = global_norm(grads, self.group, self.sharded,
                                     self.tp_group)
            count_inc = self.count + 1
            # optax computes the bias corrections in fp32
            f32 = torch.float32
            bc1 = float(1 - torch.tensor(cfg.adam_beta1, dtype=f32)
                        ** count_inc)
            bc2 = float(1 - torch.tensor(cfg.adam_beta2, dtype=f32)
                        ** count_inc)
            lrs = [float(torch.tensor(self.schedules[label](self.count),
                                      dtype=f32)) for label in LABELS]
            if self.table is not None:
                b1, b2 = cfg.adam_beta1, cfg.adam_beta2
                one = np.float32(1.0)
                # each scalar as the loop's eager ops take it: a Python float
                # rounded to fp32, a division by one as the fp32 reciprocal
                self.table.step(grads, g_norm, np.array(
                    [1 - b1, b1, 1 - b2, b2, one / np.float32(bc1),
                     one / np.float32(bc2), cfg.adam_epsilon,
                     cfg.weight_decay, cfg.max_grad_norm, -lrs[0], -lrs[1]],
                    dtype=np.float32))
            else:
                self._step_plain(grads, g_norm, bc1, bc2, lrs)
            self.count = count_inc

    def _step_plain(self, grads, g_norm, bc1: float, bc2: float,
                    lrs: List[float]) -> None:
        """The update leaf by leaf in eager ops: the CPU path, and the
        reference of the kernel's arithmetic."""
        cfg = self.cfg
        b1, b2, eps, wd = (cfg.adam_beta1, cfg.adam_beta2,
                           cfg.adam_epsilon, cfg.weight_decay)
        clip = not bool(g_norm < cfg.max_grad_norm)
        i = 0
        for label, lr in zip(LABELS, lrs):
            for _ in self.groups.get(label, ()):
                p = self.local[i]
                g = (grads[i].float() if grads[i] is not None
                     else torch.zeros_like(p, dtype=torch.float32))
                if clip:
                    g = (g / g_norm.to(g.device)) * cfg.max_grad_norm
                mu = (1 - b1) * g + b1 * self.mu[i].float()
                nu = (1 - b2) * g * g + b2 * self.nu[i]
                upd = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
                upd = upd + wd * p
                p.add_((-lr * upd).to(p.dtype))
                self.mu[i] = mu.to(self.mu[i].dtype)
                self.nu[i] = nu
                i += 1


class MultiSteps:
    """optax.MultiSteps: the running mean of k micro-batch gradients
    (acc += (g - acc) / (n + 1)); the inner optimizer steps on every k-th
    micro-batch and the mean starts again from zero."""

    def __init__(self, inner: AdamW, k: int):
        self.inner = inner
        self.k = k
        self.mini_step = 0
        self.acc = [torch.zeros_like(p, dtype=torch.float32)
                    for p in inner.local]

    @property
    def params(self) -> List[nn.Parameter]:
        return self.inner.params

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        n = self.mini_step
        with span("train.optimizer"):
            for a, g in zip(self.acc, grads):
                g = g.float() if g is not None else torch.zeros_like(a)
                a.add_((g - a) / (n + 1))
        if n == self.k - 1:
            self.inner.step(self.acc)
            for a in self.acc:
                a.zero_()
        self.mini_step = (n + 1) % self.k


def build_optimizer(model: nn.Module, cfg: TrainingConfig,
                    prefixes_to_preheat: Sequence[str] = (),
                    frozen_keywords: Sequence[str] = (),
                    preheat_only: bool = False, group=None, tp_group=None
                    ) -> Tuple[object, Dict[str, str]]:
    """(optimizer, labels): sets ``requires_grad`` from the labels, builds
    AdamW over the trainable parameters, wrapped in MultiSteps when
    ``gradient_accumulation_steps`` > 1. ``group``: the parameters are
    sharded over its ranks (FSDP2); ``tp_group``: the model is tensor-
    sharded over it."""
    labels = param_labels(model, prefixes_to_preheat, frozen_keywords,
                          preheat_only)
    groups: Dict[str, List[nn.Parameter]] = {}
    for name, p in model.named_parameters():
        p.requires_grad_(labels[name] != "frozen")
        if labels[name] != "frozen":
            groups.setdefault(labels[name], []).append(p)
    mult = cfg.fddt_lr_multiplier if cfg.use_custom_optimizer else 1.0
    sharded = {id(p): tp_dim(name) is not None
               for name, p in model.named_parameters()} if tp_group else None
    tx = AdamW(groups, cfg, mult, group, sharded, tp_group)
    if cfg.gradient_accumulation_steps > 1:
        tx = MultiSteps(tx, cfg.gradient_accumulation_steps)
    return tx, labels
