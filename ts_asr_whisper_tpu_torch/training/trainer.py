"""Trainer of the port: the fine-tune step and the reference's training
behaviours (two-phase FDDT preheat with a fresh optimizer at the unfreeze,
gradient accumulation, eval-driven early stopping, checkpoint and
best-model callbacks), on one device, data-parallel over the ranks of a
``data`` mesh axis (parallel/mesh.py: DDP, or FSDP2 under
``training.shard_params``) and tensor-parallel over a ``model`` axis
(parallel/tensor.py).

Counterpart of ts_asr_whisper_tpu/training/trainer.py:36-324.
``state.step`` counts micro-batches as the JAX trainer's does (each
call of its jitted step is one micro-batch under ``optax.MultiSteps``);
the optimizer's own count, which the learning-rate schedule reads, counts
updates. Frozen parameters have ``requires_grad`` off, so autograd neither
computes nor stores their gradients (the JAX step's ``stop_gradient``).
With ``training.use_lora`` the decoder's q/v projections get LoRA adapters
(training/lora.py) before the first optimizer is built.

Data parallelism keeps the JAX step's semantics over the global batch: each
data coordinate's loss is its share of the global batch's loss
(models/losses.py: its token sum over the global token count, all-reduced
over the ``data`` group), taken times the ``data`` size for the backward
since DDP and FSDP2 average the gradients over it; the logged loss and its
parts are the global batch's. Model peers hold the same rows and compute
the same loss, so every sum over ranks runs over the ``data`` group. Every
micro-batch all-reduces its gradients, as each JAX step does. The DDP
wrapper is built again at the unfreeze: it registers only the parameters
that need a gradient when it is built.

Tensor parallelism slices the model before it is wrapped
(``shard_model_``). The gradient norm adds the squares of the sliced
tensors over the ``model`` group. The gradients of the whole tensors are
made the same on every model rank before the clip and the update
(``sync_whole_grads``): averaged, since the card computes them through
kernels that add in run-to-run order, and, for the LoRA adapters, whole on
every rank but fed by each rank's rows of the merge, summed.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ..config import Cfg
from ..models.config import DiCoWConfig
from ..models.dicow import DiCoW
from ..models.losses import dicow_loss
from ..parallel import dist as pdist
from ..parallel.mesh import (DATA_AXIS, MODEL_AXIS, all_reduce_sum,
                             axis_group, axis_size, local, local_collectives,
                             make_mesh, release, shard_group, unwrap,
                             wrap_model)
from ..parallel.tensor import shard_model_, sync_whole_grads, tp_dim
from ..utils.logging_def import get_logger
from ..utils.observability import (MetricsLogger, global_norm,
                                   module_grad_norms, span, start_trace,
                                   stop_trace)
from .lora import init_lora, lora_linears
from .optim import build_optimizer

logger = get_logger(__name__)

BATCH_KEYS = ("input_features", "stno_mask", "labels", "upp_labels",
              "enroll_features", "enroll_stno")
PROFILE_STEPS = 12  # training.profile_dir traces the first dozen steps


def shift_tokens_right(labels: torch.Tensor, pad_token_id: int,
                       decoder_start_token_id: int) -> torch.Tensor:
    """HF shift_tokens_right semantics (labels -100 -> pad)."""
    shifted = torch.roll(labels, 1, dims=-1)
    shifted[:, 0] = decoder_start_token_id
    return torch.where(shifted == -100, pad_token_id, shifted)


def to_device(batch: Dict[str, np.ndarray], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """The collator's numpy batch -> the tensors the step reads."""
    return {k: torch.as_tensor(np.asarray(batch[k])).to(device)
            for k in BATCH_KEYS if k in batch}


def loss_fn(model: DiCoW, model_cfg: DiCoWConfig,
            batch: Dict[str, torch.Tensor], num_prefix_tokens: int,
            mesh=None, n_tokens: Optional[torch.Tensor] = None,
            world: int = 1):
    """Teacher-forced forward and the joint loss (trainer.py:59-82), with
    SE-DiCoW's enrollment features and STNO when the batch carries them.
    LoRA adapters merge in each adapted projection's call
    (training/lora.py).
    ``model`` may be a DDP / FSDP2 wrapper over the ``data`` axis of
    ``mesh``: the CTC head runs on the wrapped model, in the same backward,
    and the loss and its parts are this data coordinate's shares of the
    global batch's (one all-reduce of the token count over ``data``).
    Without ``mesh``, ``n_tokens`` and ``world`` give those shares where
    the caller knows them: the global batch's token count and the number
    of equal blocks of rows it is taken in."""
    labels = batch["labels"].long()
    dec_in = shift_tokens_right(labels, model_cfg.pad_token_id,
                                model_cfg.decoder_start_token_id)
    logits, enc_hidden = model(batch["input_features"], batch["stno_mask"],
                               dec_in, batch.get("enroll_features"),
                               batch.get("enroll_stno"))
    enc_logits = None
    if model_cfg.ctc_weight > 0.0:
        enc_logits = unwrap(model).encoder.ctc_logits(enc_hidden)
    if mesh is not None:
        world = axis_size(mesh, DATA_AXIS)
        n_tokens = all_reduce_sum((labels != -100).sum().float(),
                                  axis_group(mesh, DATA_AXIS)).clamp_min(1.0)
    upp = batch.get("upp_labels")
    return dicow_loss(logits, enc_logits, labels,
                      upp.long() if upp is not None else None, model_cfg,
                      num_prefix_tokens=num_prefix_tokens, n_tokens=n_tokens,
                      world=world)


# the parts of the loss that are shares of the global batch's (summed over
# the data group when logged); the gradient norm is every rank's alike
SHARE_KEYS = ("loss", "dec_loss", "ctc_loss")


class _NoMetrics:
    """The metrics stream of a rank other than 0: rank 0 writes it."""

    def log(self, metrics, step):
        pass

    def close(self):
        pass


@dataclass
class TrainState:
    step: int = 0
    phase: str = "base"  # "preheat" | "base"


class Trainer:
    """Training loop over an iterator of host batches; evaluation,
    checkpointing and best-model saving are callbacks (wired by train.py).
    The model's parameters are updated in place."""

    def __init__(
        self,
        cfg: Cfg,
        model: DiCoW,
        num_prefix_tokens: int = 0,
        eval_fn: Optional[Callable[[DiCoW, int], Dict[str, float]]] = None,
        checkpoint_fn: Optional[Callable[[DiCoW, int], None]] = None,
        start_step: int = 0,
        steps_per_epoch: Optional[int] = None,
        save_best_fn: Optional[Callable[[DiCoW, int], None]] = None,
        load_best_fn: Optional[Callable[[DiCoW], None]] = None,
    ):
        t = cfg.training
        if t.use_lora and not any(lora_linears(model)):
            # trainer.py:156-160: the adapters from seed + 1
            init_lora(model, torch.Generator(device=next(
                model.parameters()).device).manual_seed(t.seed + 1))
        self.cfg = cfg
        self.model = model
        self.model_cfg = model.cfg
        self.device = next(model.parameters()).device
        self.eval_fn = eval_fn
        self.checkpoint_fn = checkpoint_fn
        self.num_prefix_tokens = num_prefix_tokens
        self.steps_per_epoch = steps_per_epoch
        self.save_best_fn = save_best_fn
        self.load_best_fn = load_best_fn
        self._best_saved = False

        self.metrics_logger = MetricsLogger(
            t.output_dir, run_name=t.run_name,
            use_wandb=bool(t.report_to) and "wandb" in str(t.report_to),
            project=cfg.wandb.project) if pdist.is_zero_rank() \
            else _NoMetrics()
        self._preheat_steps = t.use_fddt_only_n_steps if t.use_fddt else 0
        self._preheat_epochs = t.use_fddt_only_n_epochs if t.use_fddt else 0
        phase = ("preheat" if (self._preheat_steps > 0
                               or self._preheat_epochs > 0) else "base")
        start_epochs = (start_step // steps_per_epoch
                        if steps_per_epoch else self._preheat_epochs)
        if (start_step >= self._preheat_steps
                and start_epochs >= self._preheat_epochs):
            phase = "base"
        model.set_gradient_checkpointing(t.gradient_checkpointing,
                                         t.remat_policy)
        model.train()
        self.state = TrainState(start_step, phase)
        self.mesh = make_mesh(t.mesh_shape, t.mesh_axis_names,
                              self.device.type)
        # the model axis: each rank keeps its slices (none at tp = 1)
        self.tp_group = axis_group(self.mesh, MODEL_AXIS)
        shard_model_(model, self.tp_group)
        self.wrapped = None
        if t.shard_params:
            # FSDP2 replaces the parameters by their shards, which the
            # optimizer then holds
            wrap_model(model, self.mesh, shard_params=True)
        self.shard_group = shard_group(model)
        self.tx = self._build_tx(preheat_only=(phase == "preheat"))
        self._wrap(init_sync=True)
        self._best_metric = None
        self._bad_evals = 0

    # -- construction helpers ------------------------------------------------
    def _build_tx(self, preheat_only: bool):
        tx, self.labels = build_optimizer(
            self.model, self.cfg.training,
            prefixes_to_preheat=self.cfg.model.prefixes_to_preheat,
            frozen_keywords=self.cfg.model.params_to_keep_frozen_keywords,
            preheat_only=preheat_only, group=self.shard_group,
            tp_group=self.tp_group)
        return tx

    def _wrap(self, init_sync: bool) -> None:
        """(Re)build the wrapper the step calls, over the parameters that
        need a gradient now."""
        if self.wrapped is not None:
            release(self.wrapped)
        self.wrapped = None
        self.wrapped = wrap_model(self.model, self.mesh,
                                  self.cfg.training.shard_params, init_sync)

    # -- phases --------------------------------------------------------------
    def _maybe_unfreeze(self) -> None:
        # the preheat phase ends once BOTH the step threshold and the epoch
        # threshold have passed; without a known epoch length the epoch
        # threshold is vacuous
        epochs_done = (self.state.step // self.steps_per_epoch
                       if self.steps_per_epoch else self._preheat_epochs)
        if (self.state.phase == "preheat"
                and epochs_done >= self._preheat_epochs
                and self.state.step >= self._preheat_steps):
            logger.info("Unfreezing at step %d (fresh optimizer state)",
                        self.state.step)
            self.tx = None  # free the preheat moments before the new ones
            self.tx = self._build_tx(preheat_only=False)
            # a DDP built in the preheat phase would never all-reduce the
            # gradients of the parameters unfrozen now
            self._wrap(init_sync=False)
            self.state.phase = "base"

    # -- one micro-batch -----------------------------------------------------
    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        """Forward, backward and the optimizer's step on one micro-batch.
        Returns the loss parts and the micro-batch's gradient norm as
        0-d tensors (read only when logged). Traced, it is a ``train.step``
        span holding ``train.forward``, ``train.backward``,
        ``train.grad_norm`` and the optimizer's ``train.optimizer``."""
        with span("train.step"):
            params = self.tx.params
            for p in params:
                p.grad = None
            with span("train.forward"):
                total, parts = loss_fn(self.wrapped, self.model_cfg, batch,
                                       self.num_prefix_tokens, self.mesh)
            with span("train.backward"):
                # DDP and FSDP2 average the gradients over the data group:
                # the sum of the shares' gradients is the global batch's
                (total * axis_size(self.mesh, DATA_AXIS)).backward()
                if self.tp_group is not None:
                    # the whole tensors' gradients alike on every model
                    # rank; the LoRA adapters' summed (each rank's rows of
                    # B A)
                    whole = [(n, p) for n, p in self.model.named_parameters()
                             if p.grad is not None and tp_dim(n) is None]
                    sync_whole_grads([local(p.grad) for _, p in whole],
                                     [n.endswith(("lora_A", "lora_B"))
                                      for n, _ in whole], self.tp_group)
            # a parameter without a gradient steps on zeros (None)
            grads = [local(p.grad) if p.grad is not None else None
                     for p in params]
            parts = {k: v.detach() for k, v in parts.items()}
            inner = getattr(self.tx, "inner", self.tx)  # under MultiSteps
            with span("train.grad_norm"):
                parts["grad_norm"] = global_norm(grads, self.shard_group,
                                                 inner.sharded, self.tp_group)
                if self.cfg.training.watch_grads:
                    # keyed as the JAX trainer's
                    # grad_norm/<encoder|decoder>/<module> and, for the LoRA
                    # adapters, grad_norm/lora/decoder
                    parts.update(module_grad_norms(
                        ((f"lora.{n.removeprefix('model.')}"
                          if n.endswith(("lora_A", "lora_B")) else n, p)
                         for n, p in self.model.named_parameters()), sep="/",
                        group=self.shard_group, tp_group=self.tp_group))
            # the update's clip takes this norm of the same gradients; under
            # MultiSteps the inner step takes the norm of their running mean
            self.tx.step(grads, **({"g_norm": parts["grad_norm"]}
                                   if self.tx is inner else {}))
            for p in params:
                p.grad = None
            return parts

    def probe_step(self, batch: Dict[str, torch.Tensor]) -> None:
        """Forward and backward of one micro-batch through the wrapper
        with no update and no collective, so that a rank can fail in it
        without leaving a peer waiting: the token count local, under DDP
        the gradient sync off (``no_sync``), and every FSDP2 all-gather and
        reduce-scatter and every tensor-parallel all-reduce replaced by an
        allocation of the same size (``parallel/mesh.py::
        local_collectives``), so that the probe holds what a training step
        holds. The memory held is the base phase's, the larger: its
        trainable set, optimizer state and, under DDP, gradient buckets (in
        the preheat phase the base optimizer is built for the probe, with a
        flat buffer of its parameters' size for the base wrapper's buckets,
        and the preheat optimizer built again after it, as it was before
        any update). The gradients are dropped. For
        ``auto_find_batch_size`` over several ranks (train.py) and the
        micro-batch ceiling of one card (scripts/probe_train_batch.py)."""
        preheat = self.state.phase == "preheat"
        ddp = hasattr(self.wrapped, "no_sync")
        buckets = None
        try:
            if preheat:
                self.tx = None
                self.tx = self._build_tx(preheat_only=False)
                if ddp:
                    buckets = torch.empty(
                        sum(p.numel() * p.element_size()
                            for p in self.tx.params),
                        dtype=torch.uint8, device=self.device)
            with local_collectives(self.model), (
                    self.wrapped.no_sync() if ddp
                    else contextlib.nullcontext()):
                total, _ = loss_fn(self.wrapped, self.model_cfg, batch,
                                   self.num_prefix_tokens)
                total.backward()
        finally:
            del buckets
            for p in self.model.parameters():
                p.grad = None
            if preheat:
                self.tx = None
                self.tx = self._build_tx(preheat_only=True)

    # -- main loop -----------------------------------------------------------
    def train(self, train_iter: Iterable[Dict[str, np.ndarray]]) -> TrainState:
        t = self.cfg.training
        last_log = time.time()
        prof = start_trace(t.profile_dir) if t.profile_dir else None
        try:
            for batch in train_iter:
                # max_steps <= 0 = HF's "train by num_train_epochs"
                # convention: the loader exhausting its epochs ends the run
                if t.max_steps > 0 and self.state.step >= t.max_steps:
                    break
                self._maybe_unfreeze()
                parts = self.train_step(to_device(batch, self.device))
                self.state.step += 1

                if self.state.step % t.logging_steps == 0:
                    parts = self._global_parts(parts)
                    parts = {k: float(v) for k, v in parts.items()}
                    dt = time.time() - last_log
                    last_log = time.time()
                    logger.info("step %d %s (%.2f s/%d steps)",
                                self.state.step,
                                {k: round(v, 4) for k, v in parts.items()},
                                dt, t.logging_steps)
                    self.metrics_logger.log(parts, self.state.step)

                spe = self.steps_per_epoch
                at_epoch_end = bool(spe) and self.state.step % spe == 0
                epochs_done = self.state.step // spe if spe else 0
                # eval_delay counts units of the active strategy
                if self.eval_fn is not None and (
                        (t.eval_strategy == "steps"
                         and self.state.step % t.eval_steps == 0
                         and self.state.step >= t.eval_delay)
                        or (t.eval_strategy == "epoch" and at_epoch_end
                            and epochs_done >= t.eval_delay)):
                    if self._run_eval():
                        break
                if self.checkpoint_fn is not None and (
                        (t.save_strategy == "steps"
                         and self.state.step % t.save_steps == 0)
                        or (t.save_strategy == "epoch" and at_epoch_end)):
                    self.checkpoint_fn(self.model, self.state.step)
                if prof is not None and self.state.step >= PROFILE_STEPS:
                    stop_trace(prof, t.profile_dir)
                    prof = None
        finally:
            if prof is not None:
                stop_trace(prof, t.profile_dir)
        if (t.load_best_model_at_end and self._best_saved
                and self.load_best_fn is not None):
            logger.info("Reloading best checkpoint (metric %s = %s)",
                        t.metric_for_best_model, self._best_metric)
            self.load_best_fn(self.model)
        self.metrics_logger.close()
        return self.state

    def _global_parts(self, parts: Dict[str, Any]) -> Dict[str, Any]:
        """The global batch's loss and parts from every rank's shares (one
        all-reduce); the parts as they are in a single-process run."""
        if self.mesh is None:
            return parts
        keys = [k for k in SHARE_KEYS if k in parts]
        summed = all_reduce_sum(torch.stack([parts[k] for k in keys]),
                                axis_group(self.mesh, DATA_AXIS))
        return {**parts, **dict(zip(keys, summed))}

    def _run_eval(self) -> bool:
        """Returns True if early stopping triggered."""
        t = self.cfg.training
        metrics = self.eval_fn(self.model, self.state.step)
        logger.info("eval @ %d: %s", self.state.step, metrics)
        self.metrics_logger.log(metrics, self.state.step)
        key = t.metric_for_best_model
        if key and key in metrics:
            value = metrics[key]
            better = (self._best_metric is None
                      or (value > self._best_metric) == t.greater_is_better)
            if better and value != self._best_metric:
                self._best_metric = value
                self._bad_evals = 0
                if self.save_best_fn is not None:
                    self.save_best_fn(self.model, self.state.step)
                    self._best_saved = True
            else:
                self._bad_evals += 1
                if (t.early_stopping_patience > 0
                        and self._bad_evals >= t.early_stopping_patience):
                    logger.info("Early stopping at step %d", self.state.step)
                    return True
        return False
