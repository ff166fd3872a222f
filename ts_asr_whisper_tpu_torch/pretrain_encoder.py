"""CTC encoder pre-training of the port, one device: everything but the CTC
head is frozen, the encoder (without FDDTs or STNO) trains with CTC on
prefix-stripped labels, then the HF export and a dev evaluation by greedy
CTC decode and WER/CER.

Counterpart of ts_asr_whisper_tpu/pretrain_encoder.py. The frozen encoder
runs under autograd only where the head's parameters need a gradient: its
parameters have ``requires_grad`` off (training/optim.py), so the backward
stops at the head, whose attention runs the flash backward
(ops/attention.py). The global-norm clip covers the head's gradients; the
JAX step, which stops no gradient, also counts the frozen encoder's there.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from .config import Cfg
from .data.collators import DataCollatorForPretraining
from .data.datasets import TS_ASR_Dataset, load_cutsets
from .decode import check_scope, no_tf32
from .eval.metrics import compute_shortform_metrics
from .models.config import DiCoWConfig
from .models.containers import WhisperContainer
from .models.dicow import DiCoW
from .models.losses import prepare_ctc_labels
from .ops.ctc import ctc_greedy_decode, ctc_loss_from_padded_labels
from .training.checkpoints import export_hf_checkpoint, save_checkpoint
from .training.dataloader import DataLoader, eval_batches
from .training.optim import build_optimizer
from .txt_norm import get_text_norm
from .utils.logging_def import get_logger
from .utils.observability import MetricsLogger

logger = get_logger(__name__)

# modules that stay trainable (pretrain_encoder.py:35-41)
PRETRAIN_TRAINABLE = (
    "encoder/additional_layer",
    "encoder/additional_self_attention_layer",
    "encoder/lm_head",
    "encoder/subsample_conv1",
    "encoder/subsample_conv2",
)


def pretrain_loss(model: DiCoW, mc: DiCoWConfig,
                  batch: Dict[str, torch.Tensor],
                  num_prefix_tokens: int) -> torch.Tensor:
    """CTC loss of the encoder's head (pretrain_encoder.py:45-53)."""
    hidden = model.encoder(batch["input_features"])
    logits = model.encoder.ctc_logits(hidden)
    labels = prepare_ctc_labels(batch["labels"].long(), mc,
                                num_prefix_tokens)
    return ctc_loss_from_padded_labels(logits, labels,
                                       blank_id=mc.ctc_vocab_size - 1)


@torch.no_grad()
def ctc_decode_chunked(model: DiCoW, mc: DiCoWConfig,
                       feats: torch.Tensor) -> torch.Tensor:
    """(B, n_mels, T) features of any length -> greedy CTC ids (B, T'):
    inputs longer than 30 s are cut into 30 s pieces, zero-padded at the
    end, and their CTC logits joined (pretrain_encoder.py:136-157)."""
    b, n_mels, t_mel = feats.shape
    window = 2 * mc.max_source_positions
    k = max(1, -(-t_mel // window))
    feats = F.pad(feats, (0, k * window - t_mel))
    chunked = feats.reshape(b, n_mels, k, window).transpose(1, 2) \
        .reshape(b * k, n_mels, window)
    logits = model.encoder.ctc_logits(model.encoder(chunked))
    logits = logits.reshape(b, k * logits.shape[1], logits.shape[-1])
    return ctc_greedy_decode(logits, mc.ctc_vocab_size - 1)


def main(cfg: Cfg, device: torch.device) -> Dict[str, float]:
    check_scope(cfg)
    no_tf32()
    cfg.model.use_fddt = False
    cfg.training.use_fddt = False
    # the plain optimizer: no preheat learning-rate multiplier
    cfg.training.use_custom_optimizer = False
    t = cfg.training
    container = WhisperContainer(cfg, device, seed=t.seed)
    model, mc, tok = container.model, container.model_config, \
        container.tokenizer
    text_norm = get_text_norm(cfg.data.train_text_norm)

    train_ds = TS_ASR_Dataset(
        load_cutsets(list(cfg.data.train_cutsets), False),
        text_norm=text_norm, use_timestamps=False,
        num_mel_bins=mc.num_mel_bins, global_lang_id=cfg.data.global_lang_id,
        dataset_weights=cfg.data.dataset_weights)
    collator = DataCollatorForPretraining(
        tokenizer=tok, bos_token_id=mc.bos_token_id,
        max_length=t.generation_max_length)
    num_prefix = len(tok.prefix_tokens) - 1

    # everything frozen but the CTC head; the JAX step applies its
    # optimizer directly, with no gradient accumulation
    tx, _ = build_optimizer(
        model, dataclasses.replace(t, gradient_accumulation_steps=1),
        prefixes_to_preheat=list(PRETRAIN_TRAINABLE), frozen_keywords=[],
        preheat_only=True)
    model.train()
    loader = DataLoader(train_ds, collator,
                        batch_size=t.per_device_train_batch_size,
                        seed=t.seed, num_workers=t.dataloader_num_workers)
    step = 0
    for batch in loader:
        if step >= t.max_steps:
            break
        batch = {k: torch.as_tensor(np.asarray(batch[k])).to(device)
                 for k in ("input_features", "labels")}
        for p in tx.params:
            p.grad = None
        loss = pretrain_loss(model, mc, batch, num_prefix)
        loss.backward()
        tx.step([p.grad for p in tx.params])  # None steps on zeros
        step += 1
        if step % t.logging_steps == 0:
            logger.info("pretrain step %d loss %.4f", step, float(loss))
        if t.save_strategy == "steps" and step % t.save_steps == 0:
            save_checkpoint(os.path.join(t.output_dir, "ckpt"),
                            model.state_dict(), step=step,
                            keep=t.save_total_limit)
    for p in tx.params:
        p.grad = None
    model.eval()

    os.makedirs(t.output_dir, exist_ok=True)
    export_hf_checkpoint(model.state_dict(), mc,
                         os.path.join(t.output_dir, "hf_export"))

    # dev evaluation: greedy CTC decode + WER (pretrain_encoder.py:117-172)
    metrics: Dict[str, float] = {}
    if cfg.data.dev_cutsets:
        mlogger = MetricsLogger(
            t.output_dir, run_name=t.run_name,
            use_wandb=bool(t.report_to) and "wandb" in str(t.report_to),
            project=cfg.wandb.project)
        for path in cfg.data.dev_cutsets:
            if not Path(path).exists():
                continue
            dev_ds = TS_ASR_Dataset(load_cutsets([path], False),
                                    text_norm=text_norm, use_timestamps=False,
                                    num_mel_bins=mc.num_mel_bins,
                                    global_lang_id=cfg.data.global_lang_id)
            preds, labels = [], []
            for _, batch in eval_batches(dev_ds, collator,
                                         t.per_device_eval_batch_size):
                feats = torch.as_tensor(batch["input_features"]).to(device)
                decoded = ctc_decode_chunked(model, mc, feats).cpu().numpy()
                preds.extend(list(decoded))
                labels.extend(list(batch["labels"]))
            name = os.path.basename(path).removesuffix(".jsonl.gz")
            res, pred_str, label_str = compute_shortform_metrics(
                preds, labels, tok, text_norm, return_texts=True)
            metrics.update({f"eval_{name}_{k}": v for k, v in res.items()})
            logger.info("pretrain eval %s: %s", name, res)
            # prediction table (evaluation.py:37-51 of the reference)
            mlogger.log_predictions(pred_str, label_str, step, tag=name)
        mlogger.close()
    return metrics
