"""Decode orchestration of the port: model container -> eval datasets ->
long-form greedy or beam joint-CTC decode -> SegLST -> tcpWER, one device
per rank. The training entry point (train.py) evaluates through the same
runner.

Counterpart of the decode part of ts_asr_whisper_tpu/train.py
(``make_generation_config`` :34-78, ``ModelTrainer._build_eval``,
``evaluate_dataset`` with its joint-decode debug printer (:166-169),
``do_eval`` and the ``decode_only`` branch of ``train``), SE-DiCoW's
enrollment cutset union included (train.py:96-99). Under torchrun the
eval batches are sharded round-robin over the ranks, the predictions
gathered, scored on rank 0 alone (which writes every output file) and the
metrics broadcast (train.py:171-243); each rank decodes on its own device,
as the JAX package's single-process mesh decode holds one row shard per
chip (longform.py:397-409).
"""

from __future__ import annotations

import copy
import dataclasses
import os
from functools import reduce
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from .config import Cfg
from .data.collators import DataCollator
from .data.datasets import build_datasets, load_cutsets
from .decoding.ctc_rescorer import set_joint_debug_decoder
from .decoding.generation_config import GenerationConfig
from .decoding.longform import longform_generate
from .eval import native
from .eval.metrics import compute_longform_metrics
from .models.containers import WhisperContainer, model_config
from .parallel import dist as pdist
from .parallel.mesh import MODEL_AXIS, check_mesh
from .training.dataloader import eval_batches
from .txt_norm import get_text_norm
from .utils.logging_def import get_logger

logger = get_logger(__name__)


def make_generation_config(container: WhisperContainer, cfg: Cfg,
                           predict_timestamps: bool = True
                           ) -> GenerationConfig:
    """update_generation_config equivalent (train.py:34-78)."""
    tok = container.tokenizer
    mc = container.model_config
    kw = dict(
        max_length=cfg.training.generation_max_length,
        num_beams=cfg.training.generation_num_beams,
        decoder_start_token_id=mc.decoder_start_token_id,
        eos_token_id=mc.eos_token_id,
        pad_token_id=mc.pad_token_id,
        bos_token_id=mc.bos_token_id,
        no_timestamps_token_id=mc.no_timestamps_token_id,
        return_timestamps=predict_timestamps,
        ctc_weight=cfg.decoding.decoding_ctc_weight or 0.0,
        length_penalty=cfg.decoding.length_penalty or 1.0,
        repetition_penalty=cfg.decoding.repetition_penalty,
        cross_kv_quant=cfg.decoding.cross_kv_quant,
        ctc_p_bf16=cfg.decoding.ctc_p_bf16,
        ctc_psi_impl=cfg.decoding.ctc_psi_impl,
        joint_debug=cfg.decoding.joint_decode_debug,
        begin_suppress_tokens=(),
        max_initial_timestamp_index=None,
    )
    if cfg.decoding.condition_on_prev:
        raise NotImplementedError(
            "condition_on_prev is not supported (matches the reference)")
    model_dir = Path(cfg.model.whisper_model)
    gen_json = model_dir / "generation_config.json"
    if model_dir.exists() and gen_json.exists():
        gc = GenerationConfig.from_json(str(gen_json), **kw)
        if not gc.lang_ids and hasattr(tok, "lang_to_id"):
            gc = dataclasses.replace(
                gc, lang_ids=tuple(sorted(tok.lang_to_id.values())))
        return gc
    if hasattr(tok, "lang_to_id"):
        kw["lang_ids"] = tuple(sorted(tok.lang_to_id.values()))
    return GenerationConfig(**kw)


def check_scope(cfg: Cfg, world: Optional[int] = None) -> None:
    """Refuse the parts of a config that the port lacks, for a run over
    ``world`` ranks (default: this process group's size): a mesh other
    than ``data`` or ``data`` x ``model`` over every rank
    (parallel/mesh.py); a ``model`` axis that would split a head or the
    MLP unevenly in a fine-tune (the port keeps whole heads on each rank,
    where GSPMD would split a head's columns); and, at a world above 1,
    what runs on one device only. A decode ignores the ``model`` axis: it
    shards its batches over every rank, as the JAX CLI builds its eval
    mesh from the local devices alone (train.py:171-181).
    ``auto_find_batch_size`` runs on any mesh, DDP or FSDP2 (train.py::
    ModelTrainer._probe: a probe before the first update that runs no
    collective)."""
    t = cfg.training
    world = pdist.world_size() if world is None else world
    shape = check_mesh(t.mesh_shape, t.mesh_axis_names, world)
    tp = dict(zip(t.mesh_axis_names, shape)).get(MODEL_AXIS, 1)
    if tp > 1 and not t.decode_only:
        mc = model_config(cfg)
        for key in ("encoder_attention_heads", "decoder_attention_heads",
                    "encoder_ffn_dim", "decoder_ffn_dim"):
            if getattr(mc, key) % tp:
                raise NotImplementedError(
                    f"a 'model' axis of {tp} does not divide {key}="
                    f"{getattr(mc, key)}: the port shards whole heads and "
                    "MLP columns evenly over the model ranks")
    if world == 1:
        return
    if t.pretrain_encoder:
        raise NotImplementedError(
            "encoder pre-training runs on one device: the JAX package gives "
            "it no mesh and no process awareness (pretrain_encoder.py)")


def scoring_backend() -> str:
    """'native' when the C++ tcpWER matchers (native/tclev.cc) load or
    build, else 'numpy' (eval/native.py's fallback)."""
    return "native" if native._load() is not None else "numpy"


def case_fold_map(tok) -> Optional[np.ndarray]:
    """(2, n) [upper ids; lower ids] from the tokenizer's lower->upper map:
    the CTC rescorer always folds case (train.py:183-194)."""
    upper_map = getattr(tok, "upper_cased_tokens", None)
    if not upper_map:
        return None
    return np.stack([
        np.fromiter(upper_map.values(), dtype=np.int64, count=len(upper_map)),
        np.fromiter(upper_map.keys(), dtype=np.int64, count=len(upper_map)),
    ])


class DecodeRunner:
    def __init__(self, cfg: Cfg, device: torch.device):
        check_scope(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        self.container = WhisperContainer(cfg, self.device,
                                          seed=cfg.training.seed)
        self.eval_text_norm = get_text_norm(cfg.data.eval_text_norm)
        # SE-DiCoW: the union of the enrollment cutsets, the speakers' pool
        # for external enrollment mixtures (train.py:96-99)
        data = cfg.data
        self.enrollment_cutset = None
        if data.use_enrollments and data.enrollment_cutsets:
            self.enrollment_cutset = reduce(
                lambda a, b: a + b,
                load_cutsets(list(data.enrollment_cutsets), False))
        self.eval_datasets = self._build_eval(cfg.data.eval_cutsets,
                                              cfg.data.eval_diar_cutsets)
        self.collator = DataCollator(
            tokenizer=self.container.tokenizer,
            bos_token_id=self.container.model_config.bos_token_id,
            max_length=cfg.training.generation_max_length,
            use_enrollments=data.use_enrollments)
        self.gen_cfg = make_generation_config(
            self.container, cfg, predict_timestamps=cfg.data.use_timestamps)
        self.windows_decoded = 0  # row-windows, seek re-decodes included

    def _build_eval(self, cutset_paths, diar_paths) -> Dict[str, object]:
        if not cutset_paths:
            return {}
        existing = [p for p in cutset_paths if Path(p).exists()
                    or Path(str(p).replace("_external_enrollment",
                                           "")).exists()]
        if not existing:
            logger.warning("No eval cutsets found among %s", cutset_paths)
            return {}
        return build_datasets(
            existing, self.cfg.data, self.eval_text_norm,
            self.container.model_config.num_mel_bins,
            diar_cutset_paths=diar_paths if self.cfg.data.use_diar else None,
            enrollment_cutset=self.enrollment_cutset)

    def evaluate_dataset(self, dataset, output_dir: str,
                         metrics_list=None, model=None) -> Dict[str, float]:
        tok = self.container.tokenizer
        model = self.container.model if model is None else model
        if self.gen_cfg.joint_debug:
            set_joint_debug_decoder(
                lambda ids: tok.decode(ids, skip_special_tokens=False))
        upper_to_lower = case_fold_map(tok)
        preds = []  # (batch_index, sequences, label keys) per decoded batch
        bs = self.cfg.training.per_device_eval_batch_size
        n_proc = pdist.world_size()
        for bi, batch in eval_batches(dataset, self.collator, bs,
                                      pad_to_full=True,
                                      batch_offset=pdist.get_rank(),
                                      batch_stride=n_proc):
            forced = batch.get("forced_decoder_ids")
            # no language from the dataset -> detection on the first window
            detect = forced is None and bool(self.gen_cfg.lang_ids)
            if forced is None:
                prefix = np.asarray(tok.prefix_tokens[:3], dtype=np.int64)
                forced = np.tile(prefix,
                                 (batch["input_features"].shape[0], 1))
            out = longform_generate(
                model, self.gen_cfg, batch["input_features"],
                batch["stno_mask"], batch["attention_mask"], forced,
                enroll_features=batch.get("enroll_features"),
                enroll_stno=batch.get("enroll_stno"),
                detect_lang=detect, upper_to_lower=upper_to_lower)
            self.windows_decoded += out.windows_decoded
            batch_keys = []
            for row in batch["labels"]:
                row = row[row != -100]
                batch_keys.append(tok.decode(row, skip_special_tokens=True))
            preds.append((bi, [np.asarray(s) for s in out.sequences],
                          batch_keys))
        if n_proc > 1:
            # every rank's predictions, rank 0 scores, the metrics go to
            # every rank (train.py:222-243)
            preds = [part for rank in pdist.gather_from_processes(preds)
                     for part in rank]
        preds.sort(key=lambda p: p[0])
        res = None
        if pdist.is_zero_rank():
            res = compute_longform_metrics(
                [s for _, ps, _ in preds for s in ps],
                [k for _, _, ks in preds for k in ks],
                dataset, tok, output_dir, self.eval_text_norm,
                metrics_list=(metrics_list
                              or self.cfg.training.eval_metrics_list),
                save_visualizations=self.cfg.training.save_visualizations)
        return pdist.broadcast_from_main(res)

    def do_eval(self, datasets: Dict[str, object], step: int = 0,
                split: str = "test", model=None) -> Dict[str, float]:
        """Decode and score each dataset as the JAX package's do_eval
        (train.py:276-311): dev evals during training score
        ``train_metrics_list``, the final test eval ``eval_metrics_list``.
        ``model``: what to decode, the container's model by default."""
        t = self.cfg.training
        metrics_list = (t.train_metrics_list if split == "dev"
                        else t.eval_metrics_list)
        model = self.container.model if model is None else model
        # bf16 eval (train.py:283-291): a decode-only run casts its weights
        # in place; a training run decodes a bf16 copy and keeps its fp32
        # parameters
        if t.bf16_full_eval and self.container.model_config.dtype == \
                "bfloat16":
            if t.decode_only:
                model.to(torch.bfloat16)
            else:
                model = copy.deepcopy(model).to(torch.bfloat16)
        metrics: Dict[str, float] = {}
        out_root = Path(t.output_dir)
        for name, ds in datasets.items():
            res = self.evaluate_dataset(
                ds, str(out_root / f"{split}_{name}" / f"step_{step}"),
                metrics_list=metrics_list, model=model)
            metrics.update({f"eval_{name}_{k}": v for k, v in res.items()})
            logger.info("eval %s@%d: %s", name, step,
                        {k: round(v, 4) for k, v in res.items()})
        if t.compute_combined_metrics or len(datasets) > 1:
            for m in metrics_list:
                prefix = m.split("_", 1)[0]
                errors = sum(v for k, v in metrics.items()
                             if k.endswith(f"_{prefix}_errors"))
                length = sum(v for k, v in metrics.items()
                             if k.endswith(f"_{prefix}_length"))
                if length:
                    metrics[f"eval_combined_{prefix}_wer"] = errors / length
        return metrics

    def run(self) -> Dict[str, float]:
        os.makedirs(self.cfg.training.output_dir, exist_ok=True)
        if not self.eval_datasets:
            raise ValueError(
                "decode_only=true but no eval cutsets could be loaded from "
                f"{self.cfg.data.eval_cutsets} -- refusing to produce an "
                "empty decode run")
        logger.info("device=%s attention=%s scoring=%s", self.device,
                    self.container.attention_impl, scoring_backend())
        return self.do_eval(self.eval_datasets)


def no_tf32() -> None:
    """fp32 stays fp32 on the card: cuDNN would otherwise run the fp32 conv
    stem in TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def main(cfg: Cfg, device: torch.device) -> Dict[str, float]:
    no_tf32()
    return DecodeRunner(cfg, device).run()
