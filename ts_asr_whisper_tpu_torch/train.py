"""Fine-tune orchestration of the port: container (+ optional weight
re-init) -> train dataset and collator (SE-DiCoW: with enrollments) ->
Trainer with long-form dev evals, checkpoint and best-model callbacks
(retried at half the micro-batch on running out of memory with
``training.auto_find_batch_size``; over several ranks, under DDP, FSDP2
and a ``model`` axis alike, the decision is taken by every rank together,
from a probe before the first update that runs no collective) -> LoRA
merge -> HF export -> final test eval.

Counterpart of the train branch of ts_asr_whisper_tpu/train.py
(``ModelTrainer.__init__`` :82-142, ``_fit`` :314-399, ``train`` :401-490).
Decoding and scoring go through ``decode.DecodeRunner``. Under torchrun the
global batch is the micro-batch times the world size (JAX train.py:354),
split over the ``data`` axis: each data coordinate loads its local rows of
it, and under tensor parallelism its ``model`` coordinate 0 alone builds
them and hands them to its model peers (``model_peer_batches``). The
Trainer runs DDP or FSDP2 over ``data`` and slices the model over
``model`` (parallel/{mesh,tensor}.py), the evaluations are sharded over
every rank, and every file of the run (checkpoints, ``metrics.jsonl``,
``hf_export/``, the eval outputs, ``store_src``) is written once, by rank
0. Under FSDP2 or tensor parallelism a decode reads a plain copy of the
model with its whole parameters on every rank, as the JAX package
replicates its parameters for decoding (longform.py:397-402).
"""

from __future__ import annotations

import dataclasses
import gc
import itertools
import os
import tarfile
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from .config import Cfg
from .data.collators import DataCollator
from .data.datasets import TS_ASR_Dataset, load_cutsets
from .decode import DecodeRunner, no_tf32
from .models.containers import WhisperContainer
from .models.dicow import DiCoW
from .parallel import dist as pdist
from .parallel.mesh import (DATA_AXIS, MODEL_AXIS, all_reduce_max,
                            all_reduce_sum, axis_group, axis_rank, axis_size,
                            full_state_dict, is_sharded,
                            load_full_state_dict)
from .parallel.tensor import model_group, model_peer_batches
from .training.checkpoints import (export_hf_checkpoint, restore_checkpoint,
                                   save_model_checkpoint)
from .training.dataloader import DataLoader
from .training.lora import init_lora, lora_linears, merge_lora, merged
from .training.trainer import Trainer, TrainState, to_device
from .txt_norm import get_text_norm
from .utils.logging_def import get_logger

logger = get_logger(__name__)

# the status of a rank's memory probe (``ModelTrainer._probe``); the run
# follows the largest over the ranks
FITS, OUT_OF_MEMORY, FAILED = 0, 1, 2


def _is_oom(e: BaseException) -> bool:
    return isinstance(e, torch.OutOfMemoryError) or \
        "out of memory" in str(e).lower()


def probe_batch(batch: Dict[str, np.ndarray], width: int
                ) -> Dict[str, np.ndarray]:
    """``batch`` with its labels (and case-invariant labels) replaced by
    ``width`` columns of text tokens, none of them padding, EOS, a
    timestamp or a task token: the longest labels, decoder input and CTC
    targets the collator can give a micro-batch of these rows. The ids
    alternate between 0 and 1, so a CTC path needs one frame a token."""
    tokens = np.arange(width) % 2
    out = dict(batch)
    for key in ("labels", "upp_labels"):
        if key in batch:
            lab = np.asarray(batch[key])
            out[key] = np.broadcast_to(tokens, (lab.shape[0], width)).astype(
                lab.dtype)
    return out


class ModelTrainer:
    def __init__(self, cfg: Cfg, device: torch.device):
        self.cfg = cfg
        self.runner = DecodeRunner(cfg, device)
        self._reinit_weights()

        data, aug = cfg.data, cfg.aug
        self.train_text_norm = get_text_norm(data.train_text_norm)
        self.train_dataset = None
        if data.train_cutsets and not cfg.training.decode_only:
            # SE-DiCoW: each row's enrollment from the enrollment cutset
            # union (external mixtures) or its own recording (train.py:
            # 103-120)
            self.train_dataset = TS_ASR_Dataset(
                load_cutsets(list(data.train_cutsets), data.use_enrollments),
                text_norm=self.train_text_norm,
                use_timestamps=data.use_timestamps,
                dataset_weights=data.dataset_weights,
                num_mel_bins=self.container.model_config.num_mel_bins,
                global_lang_id=data.global_lang_id,
                musan_augment_prob=aug.musan_augment_prob,
                musan_root=aug.musan_root,
                use_enrollments=data.use_enrollments,
                enrollment_cutset=self.runner.enrollment_cutset,
                num_other_speakers=data.number_of_mixed_speakers,
                min_overlap_ratio=data.min_enrollment_mix_overlap,
                max_overlap_ratio=data.max_enrollment_mix_overlap)
        self.dev_datasets = self.runner._build_eval(data.dev_cutsets,
                                                    data.dev_diar_cutsets)
        self.eval_datasets = self.runner.eval_datasets
        self.collator = DataCollator(
            tokenizer=self.container.tokenizer,
            bos_token_id=self.container.model_config.bos_token_id,
            max_length=cfg.training.generation_max_length,
            stno_gaussian_noise_var=aug.stno_gaussian_noise_var,
            stno_gaussian_noise_prob=aug.stno_gaussian_noise_prob,
            stno_segment_augment_prob=aug.stno_segment_augment_prob,
            stno_segment_change_prob=aug.stno_segment_change_prob,
            stno_min_segment_length=aug.stno_min_segment_length,
            stno_max_segment_length=aug.stno_max_segment_length,
            spec_aug_prob=aug.spec_aug_prob if aug.do_augment
            or aug.spec_aug_prob else 0.0,
            use_enrollments=data.use_enrollments)
        self.gen_cfg = self.runner.gen_cfg

    @property
    def container(self) -> WhisperContainer:
        return self.runner.container

    @property
    def model(self) -> DiCoW:
        return self.container.model

    def _reinit_weights(self) -> None:
        """The weight re-init loaders (train.py:86-90)."""
        m = self.cfg.model
        if m.reinit_encoder_from:
            self.container.reinit_encoder_from(m.reinit_encoder_from)
        elif m.reinit_from:
            self.container.reinit_from(m.reinit_from)

    def _rebuild_model(self, resume_path) -> None:
        """A fresh container from the initial weights, re-initialized and
        resumed as at the start (train.py:333-353): a failed attempt may
        have updated the parameters, and its memory goes first (the caller
        has dropped its Trainer, and with it the FSDP2 shards and hooks, the
        sliced parameters and the optimizer state). The resumed weights go
        into the plain model, which the next Trainer slices and shards as
        it did the first."""
        self.runner.container = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        self.runner.container = WhisperContainer(
            self.cfg, self.runner.device, seed=self.cfg.training.seed)
        self._reinit_weights()
        if resume_path:
            state, _ = restore_checkpoint(str(resume_path))
            self.model.load_state_dict(state["params"])
            logger.info("Re-restored resume checkpoint %s after the OOM "
                        "retry", resume_path)

    def _plain_model(self, model: DiCoW) -> DiCoW:
        """``model`` itself, or, when FSDP2 or tensor parallelism shards
        it, a plain copy in eval mode with its whole parameters (and LoRA
        adapters) on every rank (a collective)."""
        if not is_sharded(model) and model_group(model) is None:
            return model
        state = full_state_dict(model, to_cpu=False)
        with torch.device(self.runner.device):
            plain = DiCoW(model.cfg, flash=model.encoder.flash)
        if any(lora_linears(model)):
            init_lora(plain, torch.Generator(device=self.runner.device))
        plain.to(self.container.model_config.storage_dtype)
        plain.load_state_dict(state)
        return plain.eval()

    def _store_run_artifacts(self) -> None:
        """training.store_src: the composed config and a snapshot of the
        package's sources next to the run."""
        import yaml

        out = Path(self.cfg.training.output_dir)
        with open(out / "config.yaml", "w") as f:
            yaml.safe_dump(dataclasses.asdict(self.cfg), f,
                           default_flow_style=False)
        pkg_root = Path(__file__).resolve().parent
        with tarfile.open(out / "src.tar.gz", "w:gz") as tar:
            for py in sorted(pkg_root.rglob("*.py")):
                tar.add(py, arcname=str(py.relative_to(pkg_root.parent)))
        logger.info("store_src: wrote config.yaml + src.tar.gz to %s", out)

    def _fit(self, num_prefix: int, start_step: int, eval_fn, checkpoint_fn,
             save_best_fn, load_best_fn, resume_path=None) -> TrainState:
        """Build the Trainer and the loader and run; with
        ``auto_find_batch_size`` an attempt that runs out of memory is
        retried at half the micro-batch and twice the accumulation (the
        same global batch) on a model rebuilt from its initial or resumed
        weights (train.py:314-399). In one process the retry follows an
        out-of-memory error at any step. Over several ranks (DDP or FSDP2
        over ``data``, with or without a ``model`` axis) every rank probes
        its memory before the first update and the ranks halve together
        (``_probe``); an out-of-memory error after the probe raises. Any
        other error is raised."""
        t = self.cfg.training
        world = pdist.world_size()
        retry = False
        while True:
            if retry:
                self._rebuild_model(resume_path)
            local_bs = t.per_device_train_batch_size
            global_bs = local_bs * world
            spe = len(self.train_dataset) // global_bs or None
            if t.max_steps <= 0:
                # HF convention: train by epochs; derive the step budget so
                # the lr schedule and the loop agree
                t.max_steps = (spe or 1) * t.num_train_epochs
                logger.info("max_steps<=0: training %d epochs = %d steps",
                            t.num_train_epochs, t.max_steps)
            trainer = Trainer(self.cfg, self.model,
                              num_prefix_tokens=num_prefix,
                              eval_fn=eval_fn if self.dev_datasets else None,
                              checkpoint_fn=checkpoint_fn,
                              save_best_fn=save_best_fn,
                              load_best_fn=load_best_fn,
                              start_step=start_step, steps_per_epoch=spe)
            mesh = trainer.mesh
            loader = DataLoader(
                self.train_dataset, self.collator, batch_size=global_bs,
                seed=t.seed, num_workers=t.dataloader_num_workers,
                prefetch_factor=t.dataloader_prefetch_factor,
                worker_type=t.dataloader_worker_type,
                num_epochs=(None if t.max_steps and t.max_steps > 0
                            else t.num_train_epochs),
                # each data coordinate feeds its local rows of every
                # global batch
                process_index=axis_rank(mesh, DATA_AXIS),
                process_count=axis_size(mesh, DATA_AXIS))
            build = axis_rank(mesh, MODEL_AXIS) == 0
            batches = model_peer_batches(loader if build else (),
                                         axis_group(mesh, MODEL_AXIS), build)
            if t.auto_find_batch_size and world > 1:
                batches = self._probe(trainer, batches)
            if batches is not None:
                try:
                    return trainer.train(batches)
                except Exception as e:
                    if not (t.auto_find_batch_size and world == 1
                            and _is_oom(e) and local_bs > 1):
                        raise
            # outside the handler: the traceback no longer holds the
            # failed attempt's tensors
            trainer = loader = batches = None
            t.per_device_train_batch_size = local_bs // 2
            t.gradient_accumulation_steps *= 2
            logger.warning("OOM at per-device batch %d -> retrying with %d "
                           "(grad accumulation x2)", local_bs,
                           t.per_device_train_batch_size)
            retry = True

    def probe_width(self) -> int:
        """The widest labels the collator can give: generation_max_length
        rounded up to the collator's multiple, at most the decoder's
        positions."""
        mult = self.collator.pad_labels_to_multiple_of or 1
        return min(-(-self.collator.max_length // mult) * mult,
                   self.container.model_config.max_target_positions)

    def _probe(self, trainer: Trainer, batches: Iterable
               ) -> Optional[Iterable]:
        """The memory probe of ``auto_find_batch_size`` over several
        ranks: one decision that every rank takes, with no rank left
        waiting in a collective.

        Each rank runs ``Trainer.probe_step`` (forward and backward through
        the wrapper with no collective: the DDP gradient sync off, FSDP2's
        all-gathers and reduce-scatters and the tensor-parallel all-reduces
        replaced by allocations of their size; the base phase's trainable
        set, optimizer state and gradient buckets) on its first micro-batch
        with the labels made the longest the collator can give
        (``probe_batch``): generation_max_length rounded up to the
        collator's multiple, every column a text token. No real micro-batch
        can exceed it: the rows are as many, the features always 30 s
        windows (and the enrollments of SE-DiCoW too), and the labels'
        width, the decoder's length and the CTC targets' length are the
        only shapes that vary, each at its maximum here. The communicators
        of the ``data`` and ``model`` groups are used once before the
        probe's peak is reset, so that their buffers are in place as in
        training. The probe catches any exception; then one MAX all-reduce
        (on the host) of every rank's status (``FITS``, ``OUT_OF_MEMORY``,
        ``FAILED``): on ``FITS`` every rank trains on its batches, the
        first one included (returned); on ``OUT_OF_MEMORY`` every rank
        halves (None is returned), or raises at micro-batch 1; on
        ``FAILED`` every rank raises: the failing rank its own error, the
        others a RuntimeError that names it."""
        t = self.cfg.training
        it = iter(batches)
        first = next(it)
        width = max(self.probe_width(), np.asarray(first["labels"]).shape[1])
        mesh = trainer.mesh
        for axis in (DATA_AXIS, MODEL_AXIS):
            group = axis_group(mesh, axis)
            if group is not None:
                all_reduce_sum(torch.zeros(1, device=trainer.device), group)
        error, t0 = None, time.perf_counter()
        cuda = trainer.device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(trainer.device)
        try:
            trainer.probe_step(to_device(probe_batch(first, width),
                                         trainer.device))
            if cuda:
                torch.cuda.synchronize(trainer.device)
        except Exception as e:
            error = e
        status = (FITS if error is None
                  else OUT_OF_MEMORY if _is_oom(error) else FAILED)
        peak = ""
        if cuda:
            gib = torch.cuda.max_memory_allocated(trainer.device) / 2**30
            peak = f", peak {gib:.2f} GiB"
        logger.info("auto_find_batch_size probe at per-device batch %d, "
                    "labels %d wide, mesh (data %d, model %d), "
                    "shard_params %s: %s in %.0f ms%s",
                    t.per_device_train_batch_size, width,
                    axis_size(mesh, DATA_AXIS), axis_size(mesh, MODEL_AXIS),
                    t.shard_params, ("fits", "out of memory", "failed")[status],
                    (time.perf_counter() - t0) * 1e3, peak)
        codes = torch.zeros(pdist.world_size(), dtype=torch.int64)
        codes[pdist.get_rank()] = status
        codes = all_reduce_max(codes).tolist()
        decision = max(codes)
        if decision == FITS:
            return itertools.chain([first], it)
        it.close()  # the loader's workers stop
        ranks = [r for r, c in enumerate(codes) if c == decision]
        if decision == OUT_OF_MEMORY and t.per_device_train_batch_size > 1:
            error = None  # frees the failed probe's tensors
            return None
        if status == decision:
            raise error
        what = ("ran out of memory at per-device batch 1"
                if decision == OUT_OF_MEMORY else "failed")
        raise RuntimeError(f"auto_find_batch_size: the memory probe {what} "
                           f"on rank(s) {ranks}; see their errors")

    def train(self) -> Dict[str, float]:
        t = self.cfg.training
        os.makedirs(t.output_dir, exist_ok=True)
        if t.store_src and pdist.is_zero_rank():
            self._store_run_artifacts()
        if t.decode_only:
            return self.runner.run()
        if self.train_dataset is None or not len(self.train_dataset):
            raise ValueError("training needs data.train_cutsets: none could "
                             f"be loaded from {self.cfg.data.train_cutsets}")

        num_prefix = len(self.container.tokenizer.prefix_tokens) - 1
        # resume / restart: parameters restored; the optimizer state starts
        # fresh at the restored step
        start_step = 0
        resume_path = t.resume_from_checkpoint or t.restart_from or None
        if resume_path:
            # every rank, before the Trainer wraps the model
            state, start_step = restore_checkpoint(str(resume_path))
            self.model.load_state_dict(state["params"])
            logger.info("Resumed params from %s at step %d", resume_path,
                        start_step)

        def eval_fn(model, step):
            # LoRA: the dev decode reads the adapted weights, merged once
            with merged(self._plain_model(model)) as plain:
                return self.runner.do_eval(self.dev_datasets, step, "dev",
                                           model=plain)

        def checkpoint_fn(model, step):
            save_model_checkpoint(os.path.join(t.output_dir, "ckpt"), model,
                                  step=step, keep=t.save_total_limit)

        best_dir = os.path.join(t.output_dir, "ckpt_best")

        def save_best_fn(model, step):
            save_model_checkpoint(best_dir, model, step=step, keep=1)

        def load_best_fn(model):
            state, _ = restore_checkpoint(best_dir)
            load_full_state_dict(model, state["params"])

        state = self._fit(num_prefix, start_step,
                          eval_fn if t.predict_with_generate else None,
                          checkpoint_fn, save_best_fn, load_best_fn,
                          resume_path)
        # the export and the final eval take a plain model
        self.runner.container.model = self._plain_model(self.model)
        if any(lora_linears(self.model)):
            # the export and the final eval take the merged weights
            # (train.py:463-468)
            merge_lora(self.model)

        g = self.gen_cfg
        gen_json = {
            "max_length": g.max_length,
            "decoder_start_token_id": g.decoder_start_token_id,
            "eos_token_id": g.eos_token_id,
            "pad_token_id": g.pad_token_id,
            "bos_token_id": g.bos_token_id,
            "no_timestamps_token_id": g.no_timestamps_token_id,
            "return_timestamps": g.return_timestamps,
            "ctc_weight": g.ctc_weight,
            "suppress_tokens": list(g.suppress_tokens),
            "begin_suppress_tokens": None,
        }
        if pdist.is_zero_rank():
            export_hf_checkpoint(self.model.state_dict(),
                                 self.container.model_config,
                                 os.path.join(t.output_dir, "hf_export"),
                                 generation_config=gen_json)
        pdist.barrier("hf_export")
        if self.eval_datasets and t.predict_with_generate:
            return self.runner.do_eval(self.eval_datasets, state.step, "test")
        return {}


def main(cfg: Cfg, device: torch.device) -> Dict[str, float]:
    no_tf32()
    return ModelTrainer(cfg, device).train()
