#!/usr/bin/env python
"""Smoke run of the PyTorch port (ts_asr_whisper_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it breaks:
  1. the card: nvidia-smi name and power limit, torch and CUDA versions;
     no CUDA device -> exit 2, there is no CPU path;
  2. build the eight CUDA kernels from the six sources of kernels/csrc with
     nvcc, one nvcc per source, all started together;
  3. flash attention vs its plain PyTorch version at the encoder's shapes,
     bf16 and fp32, output and row log-sum-exp, with errors and median
     times (CUDA events, warmed up), device time (torch.profiler), TFLOP/s
     and the share of the bound at the main shape;
     F.scaled_dot_product_attention timed beside it as a yardstick only;
  3b. the flash-attention backward vs its plain version, both fed the
     kernel forward's (out, lse), at the fine-tune shape (4, 20, 1500, 64)
     and T 1499, 1000 and 257, bf16 and fp32, timed with CUDA events and
     torch.profiler beside the backward of F.scaled_dot_product_attention;
     FlashMHA end to end against autograd through the plain forward in
     fp32;
  4. beam ancestry attention vs its plain version at beam 5 x batch 2,
     20 heads, cache lengths 128 and 448, pos 0, 1, mid and last, bf16 and
     fp32 on uniform ancestors; then on a beam search's own ancestry map
     (beams share prefixes), and one launch captured in a CUDA graph with
     pos in a device int32, replayed at three positions;
  5. the candidate CTC-psi gather + dot vs its plain version at the turbo
     vocab (51866), 375 CTC frames, 10 hypotheses x 512 candidate slots,
     fp32 and bf16 posteriors from blank-dominant logits (so every frame
     weighs in each sum), the psi it feeds against the CPU path, and one
     call captured in a CUDA graph and replayed on new weights;
     phases 4 and 5 time each call with CUDA events and, apart, the device
     time of its kernels with torch.profiler, and print the main shape's
     device time, share of the bound and per-call time beside those of the
     kernels' first design;
  5b. the two KV-cache reorder kernels ('bhtd' and 'tbhd') vs their plain
     versions, bit for bit, in bf16 and fp32, at the beam step's cache
     (4, 10, 20, 128, 64), at T 448 and at Bb 15 (batch 3 x 5), with source
     rows drawn with repeats, the identity and a reversal within groups;
     CUDA-event and profiler times beside torch.index_select's;
  5c. the fine-tune's multi-tensor kernels at the dicow_v3 cell's trained
     leaf set (761 leaves, 720 M fp32 parameters at turbo width): the
     norm against the plain sum, two AdamW updates with the clip on against
     the per-leaf loop bit for bit; times beside the bounds, the plain
     versions, torch.optim.AdamW(fused=True) and torch._foreach_norm;
  6. the large-v3-turbo DiCoW encoder at fp32 on 2 windows, through the
     kernel and through plain attention;
  7. long-form greedy decode of a synthetic 16-row corpus (8 two-speaker
     recordings of 60 s) at large-v3-turbo width with random weights,
     through the decode entry point with the dicow_v3_greedy settings;
     every encoder layer must have run the flash kernel;
  8. long-form beam-5 joint-CTC decode (dicow_v3_beam_joint) of 8 rows
     (4 two-speaker recordings of 60 s, 4 calls of batch 2) at the same
     width: every beam step must have run the ancestry kernel in each
     decoder layer and the psi kernel once; both decodes must have scored
     with the native tcpWER library, not the numpy fallback;
  9. the DiCoW v3 fine-tune (+train=dicow_v3) through the training entry
     point (ModelTrainer) at the same width: 16 rows (8 two-speaker
     recordings of 30 s), 8 micro-batches of 4 with gradient accumulation
     over 2, 2 preheat updates then 2 base updates with a fresh optimizer,
     and the HF export: every loss finite, the flash forward and backward
     kernels launched in every encoder layer and the CTC head of every
     micro-batch, the preheat phase changing only preheat parameters, the
     base phase leaving the decoder bit-identical, the export loading
     strictly into the port's container;
 10. SE-DiCoW long-form beam-5 joint-CTC decode (se_dicow_beam_joint, 8 SCBs,
     self-enrollment from the recordings, CTC weight 0.3) of 4 rows (2
     two-speaker recordings of 60 s, 2 calls of batch 2) at the same width,
     with the standalone-permute reorder ('pallas') on the 'bhtd' cache:
     every beam step must have launched kv_reorder_bhtd twice (k and v) and
     the psi kernel once, the ancestry kernel never, and every encoder call
     the flash kernel in its 32 layers and 8 SCB cross-attentions;
 11. the same decode of 1 recording (2 rows) on the 'tbhd' cache:
     kv_reorder_tbhd twice per beam step, kv_reorder_bhtd never. The reorder
     impl and the cache layout are restored afterwards;
 12. the SE-DiCoW fine-tune (+train=se_dicow, 8 SCBs, self-enrollment)
     through ModelTrainer at the same width: 8 rows of 30 s, 4
     micro-batches of 4 in updates of 2 (one preheat, one base), every SCB
     gate opened first (a fresh gate is 0 and would stop every SCB
     gradient): the flash forward and backward in every encoder layer, SCB
     and the CTC head; the preheat changing only preheat parameters, the
     SCBs' k/v projections among them (their gradient comes only through
     the SCB cross-attention's dk / dv); the flash forward and backward
     against their plain versions on the run's own inputs of SCB 0's
     cross-attention and of layer 0's self-attention over both streams;
     the export decoded by se_dicow_greedy;
 13. encoder CTC pre-training (+pretrain=turbo) through its entry point: 4
     steps at micro-batch 8 with the encoder frozen (flash forward in every
     layer, forward and backward in the CTC head's self-attention), a dev
     evaluation of 60 s recordings in 30 s pieces by greedy CTC; only the
     CTC head moves; the head's flash forward and backward against their
     plain versions on the first step's own inputs;
 14. 2 micro-batches of the dicow_v3 fine-tune under gradient
     checkpointing with the remat policies 'full', 'dots' and 'attn' from
     the same weights and batches: equal losses, gradients within the bf16
     dq tolerance, one flash forward fewer per layer under 'attn'; ms per
     micro-batch and peak memory of each; the flash forward and backward
     against their plain versions on layer 0's own inputs;
 15. the dicow_v3 fine-tune with LoRA (training.use_lora=true): only the
     adapters and the non-decoder parameters move, and the export has no
     adapter keys and equals the merge;
 16. long-form beam-5 joint-CTC decode (dicow_v3_beam_joint) of 1 recording
     of 60 s (2 rows) over the int8 cross-KV (decoding.cross_kv_quant=true)
     with a generation_config.json asking for temperature-fallback retries
     (FALLBACK_GEN): the retries per window printed, both temperatures
     reached; the ancestry kernel in every decoder layer of every beam
     step, the psi kernel once per beam step and never in a (greedy) retry;
     a second run gives the same hypotheses; layer 0's cross-attention on
     its own inputs, int8 against exact, within tests/test_kv_quant.py's
     bound;
 17. long-form greedy decode with token timestamps (longform_generate,
     alignment heads TS_HEADS) of 2 recordings of 60 s (4 rows): per-token
     times on every segment, non-decreasing and inside their window; the
     flash kernel in every encoder layer; ms per greedy step with and
     without the alignment collection;
 18. (run after phase 7, on its model) greedy decode of phase 7's first
     window at batch 16 over the exact and the int8 cross-KV: ms per step,
     device ms per step (utils/devicetime.py), cross-KV bytes, peak memory;
 19. (run after phase 6) the device log-mel
     (ops/mel.py) against the host featurizer over 16
     windows of 30 s at 128 mels, within tests/test_mel.py's tolerance, ms
     per window of each; the beam step's candidate top-10 over (2, 5 x
     51866), thresholded against the stable sort, equal and timed.
 20. the dicow_v3 fine-tune of phase 9 (its corpus, recipe and micro-batches
     of 4, with the augmentations off: they draw from unseeded global
     generators) at DP_LAYERS encoder layers, as phases 21-23, 25, 26 and
     28's [2] launch, through the CLI under torchrun, one rank over NCCL,
     once with DDP and once with FSDP2 (training.shard_params=true):
     the losses of the 2 micro-batches before the first update within
     1e-5 of an unwrapped run's, the later ones within the tolerance set by
     two unwrapped runs of this process (10 x their largest relative
     difference, at least 1e-6), the flash forward and backward in every
     encoder layer and the CTC head of every micro-batch; ms per update
     (the two launches share the card at once, and phase 21's) and peak
     memory;
21. the same fine-tune on two ranks that share the card over gloo (each
     rank on cuda:0, 2 x micro-batch 2 on the rows of the unwrapped runs'
     micro-batches of 4), through the preheat -> base unfreeze: both ranks
     log the same losses and end with the same checksums of every
     trainable parameter; the losses are held to DP_SPLIT_RUNS runs in
     this process that split each micro-batch of 4 as the two ranks do
     (each block of 2 rows its own forward and backward, the gradients
     summed in fp32), within 1e-5 before the first update and 10 x the
     larger spread of those runs and of the unwrapped pair in all (each
     rank's bf16 gradients over its own rows move the losses from the
     unwrapped run's by more than a pair of unwrapped runs samples), and
     nearer those runs than the unwrapped run, whose forward they match
     within 1e-5 before the first update; the all-reduce bytes per
     micro-batch;
 22. rank-sharded long-form eval: dicow_v3_greedy on phase 7's recordings at
     per_device_eval_batch_size 4 through the CLI on two ranks sharing the
     card over gloo: rank 0 decodes batches 0 and 2, rank 1 batches 1 and
     3, the flash forward runs in both; the hypotheses and metrics equal
     this process's decode at batch 4, and only rank 0 writes the outputs;
     its ranks are launched beside phase 23's.
     Phases 20-22 read wall time only.
 23. (run after phase 21, on its corpus and unwrapped runs) the fine-tune
     tensor-parallel over a mesh [1, 2] ('data' x 'model') at full turbo
     width: two ranks share the card over gloo through torchrun
     and the CLI, each holds 10 of the 20 heads of every attention and
     half of every MLP, and both read phase 9's micro-batches of 4: both
     ranks log bit-identical losses and gradient norms, within
     TP_FORWARD_TOL of the unwrapped run's before the first update and the
     phase-20 tolerance after it; the replicated trainable tensors end with
     equal checksums on both ranks; the gathered export loads strictly
     into a single-process container; the flash forward and backward in
     every encoder layer and the CTC head of every micro-batch, as
     unwrapped, and against their plain versions on layer 0's own inputs
     at (4, 10, 1500, 64); the TP all-reduce bytes per micro-batch, ms per
     update and peak memory per rank;
 24. +train=se_dicow on a mesh [2, 2] (DDP over 'data' x TP over 'model'):
     four ranks share the card over gloo, at full width and a reduced
     depth (4 encoder layers, 2 SCBs with their gates opened,
     self-enrollment), 8 micro-batches of 4 rows (4 preheat, then 4 base,
     in updates of 2), each split over the two data coordinates: the data
     coordinates read different rows, the model
     peers log equal losses, and the global losses lie within
     TP_FORWARD_TOL of an unwrapped run of the same model before the first
     update and within 10 x the spread of 4 unwrapped runs of a DDP run on
     two ranks after it (launched beside it: the same split of every
     micro-batch, whose bf16 weight gradients over 2 rows a rank move the
     losses further than any unwrapped pair samples; DDP's ranks read the
     data coordinates' rows, log the same losses, within DP_FORWARD_TOL
     of the unwrapped run's before the first update, and end with equal
     checksums); the SCB cross-
     attention's flash forward and backward at 10 local heads, against
     their plain versions on SCB 0's own inputs;
 25. (on phase 20's corpus) the fine-tune with LoRA (training.use_lora=
     true) at full width and DP_LAYERS encoder layers, 4
     micro-batches with no preheat (2 updates), on two ranks
     sharing the card over gloo at micro-batch 2, with DDP and with FSDP2
     (training.shard_params=true), the two launched side by side: each
     run's ranks log the same losses;
     before the first update both are within DP_FORWARD_TOL of an
     unwrapped LoRA run in this process, and FSDP2's losses stay within 10
     x the largest spread of 4 unwrapped LoRA runs of DDP's on the same
     split of every micro-batch; FSDP2's gathered
     adapters and weights end with equal checksums on both ranks; the flash
     forward and backward in every encoder layer and the CTC head of every
     micro-batch, and against their plain versions on layer 0's own inputs
     under FSDP2; the FSDP2 all-gather and reduce-scatter bytes and calls
     per micro-batch, ms per update and peak memory per rank;
 26. (launched beside phase 25's pair) phase 21's fine-tune with
     training.auto_find_batch_size=true, started at micro-batch 4 and
     accumulation 1 on two DDP ranks over gloo, rank 1's memory capped at
     AUTOBATCH_CAP_GIB: rank 1's memory probe runs out of memory at
     micro-batch 4, rank 0's fits, and both ranks halve together to
     micro-batch 2 and accumulation 2 (phase 21's settings), where both
     probes fit; the ranks log the same finite losses, held as phase
     21's are and within the same tolerance of phase 21's, the flash forward
     and backward in every encoder layer and the CTC head of every
     micro-batch, and the loop peaks under the probe; each probe's
     outcome, time, peak memory and flash launches per rank, the memory
     allocated before the first attempt and after the rebuild (as
     phase 28);
 28. auto_find_batch_size under FSDP2 (training.shard_params=true), two
     launches over gloo side by side, each from micro-batch 4 and
     accumulation 1 over AUTOBATCH_SHARDED_STEPS micro-batches (one base
     update after the halving): dicow_v3 on a mesh [2] at DP_LAYERS
     encoder layers, rank 1 capped, and on a mesh [2, 2] (FSDP2 over
     'data' x TP over 'model', 4 ranks) at 4 encoder layers, rank 3
     capped (AUTOBATCH_SHARDED). The probe runs the wrapped forward and
     backward with every collective replaced by an allocation of its size
     (parallel/mesh.py::local_collectives): each capped rank's probe runs
     out of memory at 4, the others fit, every rank halves to 2 and 2 and
     fits; the ranks log the same finite losses; every rank's model comes
     back after the rebuild to the memory it held when the first attempt
     started (within REBUILD_SLACK_GIB); the training loop peaks under
     the probe at 2; the flash forward and backward in every encoder layer
     and the CTC head of every micro-batch; each probe's ms, peak and
     flash launches per rank.
After phase 28, the device-time gate: the flash forward's device time at
     (16, 20, 1500, 64) bf16 read again (utils/devicetime.py, the one
     device-time function of every phase and tool) must lie within
     DEVICE_TIME_GATE of phase 3's; both traces are printed kernel by
     kernel, after their lead and without one (a trace loses the device
     records of its first launches, more of them the older the process).
 27. the device tools of ts_asr_whisper_tpu_torch/scripts, each a child
     process at full turbo width that must exit 0: export_dicow of a
     checkpoint of the turbo width at DP_LAYERS encoder layers,
     saved before phase 28 (run on the CPU beside phase 28 and
     the next three tools; the export loads strictly into the port's
     container and equals the saved model), cuda_kernel_check (all six
     kernels against their plain versions), probe_psi_gather --quick,
     probe_train_batch at micro-batches 4 and 8, smoke_decode of the
     export on phase 7's recordings (scored by the native tcpWER library),
     and profile_decode at --max-new 32 and with --reorder pallas (every
     stage with its device ms). Each tool's printed kernel launches join the kernels
     record under "tool:<name>" (not counted in "launches").
The line before the last is a JSON record of the kernels; the last line is
{"ok": true, "device": {...}}. Nothing here imports jax or the JAX package.
"""

from __future__ import annotations

import gc
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

# the port must never reach jax, nor any module of the JAX package
sys.modules["jax"] = None
sys.modules["ts_asr_whisper_tpu"] = None

import torch  # noqa: E402

# the one device-time function of the port (utils/devicetime.py); the
# probes under scripts/ that import this file call it as device_ms
from ts_asr_whisper_tpu_torch.utils.devicetime import (  # noqa: E402
    kernel_trace, measure_device_ms)

device_ms = measure_device_ms
ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
TURBO = {"vocab_size": 51866, "num_mel_bins": 128, "d_model": 1280,
         "encoder_layers": 32, "decoder_layers": 4,
         "encoder_attention_heads": 20, "decoder_attention_heads": 20,
         "encoder_ffn_dim": 5120, "decoder_ffn_dim": 5120,
         "max_source_positions": 1500, "max_target_positions": 448}
# the ported TPU kernels (what cuda_kernel_check checks), then the
# fine-tune's multi-tensor kernels, which replace none
PORTED = ("flash_attn_fwd", "flash_attn_bwd", "ancestry_attn",
          "psi_gather_dot", "kv_reorder_bhtd", "kv_reorder_tbhd")
KERNELS = PORTED + ("adamw_multi", "sq_norm_multi")
ENC_SHAPE = (16, 20, 1500, 64)   # turbo encoder attention at batch 16
RAGGED_T = (257, 1000, 1499)
TOLS = {torch.float32: (2e-5, 1e-5),   # as tests/test_attention.py
        torch.bfloat16: (1e-2, 1e-2)}  # bf16 rounding of p and out dominates
# the forward's row log-sum-exp against the plain version's (atol = rtol):
# fp32 scores in both, the row sums in another order
LSE_TOL = 1e-5
# the backward at the fine-tune's micro-batch of 4
BWD_SHAPE = (4, 20, 1500, 64)
BWD_T = (1500, 1499, 1000, 257)
BWD_F32_TOL = 2e-4   # atol = rtol, as tests/test_attention.py:63
# bf16: relative error of dq/dk/dv in Frobenius norm; the bf16 rounding of
# ds and p before the products dominates
BWD_BF16_REL = 1e-2
# one H100 SXM (NVIDIA data sheet): dense bf16 tensor-core and fp32 rates,
# memory rate
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
# fp32 encoder, kernel vs plain attention: both fp32 with no TF32; the only
# difference is summation order (~1e-6 per attention), carried through 32
# residual layers and the FDDTs of a random-weight model
ENC_ATOL = 1e-3
# beam slice: dicow_v3_beam_joint decodes batch 2 with 5 beams
BEAMS, AUDIO_ROWS = 5, 2
ANC_T = (128, 448)               # generation_max_length 128; the model's max
ANC_TOLS = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-2, 1e-2)}
ANC_MAIN = (448, 224, torch.bfloat16)  # mid-way through a full-length decode
ANC_REPLAY = (3, 224, 447)       # device positions of the graph replay
# the beam kernels' numbers in their first design (a block of 8 warps per
# (hypothesis, head), a warp per key; a warp walking 2 candidate rows),
# measured by this script on an H100 80GB HBM3 at 700 W (PERF.md), printed
# beside this run's
FIRST_DESIGN = {"ancestry_attn": "0.0217 ms, per call 0.052-0.085 ms",
                "psi_gather_dot": "0.0047-0.0048 ms, per call 0.048-0.107 ms"}
# CTC psi: the posterior has 375 frames (two stride-2 convs after the
# encoder); fp32 sums in another order
CTC_T, PSI_TOL = 375, 2e-5
# blank logit offset of the synthetic CTC posterior: blank takes ~99.3% of
# each frame, as a trained CTC head gives, so the psi weights w stay within
# 1e-3 of their maximum over (nearly) all 375 frames and every frame of a
# candidate row counts in its sum
BLANK_LOGIT, W_SPAN = 20.0, 300
# KV-cache reorder: the beam step's self-attention cache, (L, Bb, H, T, hd)
# in 'bhtd' and (L, T, Bb, H, hd) in 'tbhd', at (T, Bb): the decode's
# generation_max_length 128 at batch 2 x 5 (the main shape) and 3 x 5, and
# the model's maximum 448
REORDER_CASES = ((128, 10), (128, 15), (448, 10))
REORDER_KINDS = ("repeats", "identity", "reversal")
# the multi-tensor optimizer phase: the dicow_v3 cell's model settings
# (benchmark/configs/dicow_v3_turbo.json) at turbo width; the norm kernel
# sums in double where _sq_sum sums in fp32
OPTIM_MODEL = dict(ctc_weight=0.3, additional_self_attention_layer=True,
                   pre_ctc_sub_sample=True, fddt_is_diagonal=True,
                   use_pre_pos_fddt=True, apply_fddt_to_n_layers=-1,
                   non_target_fddt_value=0.5, max_source_positions=1500,
                   max_target_positions=448)
OPTIM_NORM_RTOL = 1e-5
# SE-DiCoW: se_dicow_greedy.yaml's SCB count
SCB_LAYERS = 8
# the fallback ladder of Whisper's published generation_config.json
# (temperatures, log-prob and no-speech thresholds) with HF's default
# compression-ratio threshold 2.4; random weights fail the log-prob check,
# so every window retries
FALLBACK_GEN = {"temperature": [0.0, 0.4, 0.8], "logprob_threshold": -1.0,
                "no_speech_threshold": 0.6,
                "compression_ratio_threshold": 2.4}
# the int8 decode step against the exact one (tests/test_kv_quant.py):
# max |dh| < KV_QUANT_REL * std(h_exact)
KV_QUANT_REL = 0.05
# token timestamps: 6 alignment heads in turbo's decoder layers 2-3 (any
# heads serve with random weights)
TS_HEADS = ((2, 1), (2, 7), (2, 13), (3, 4), (3, 10), (3, 16))
# device log-mel against the host featurizer: tests/test_mel.py's
# tolerance
MEL_ATOL, MEL_RTOL = 5e-5, 1e-5
# phases 20-21 compare losses step by step: the collator draws its STNO and
# SpecAug augmentations from numpy's and Python's unseeded global
# generators (data/augmentations.py), so those runs leave them off
NO_AUG = ("aug.stno_gaussian_noise_prob=0.0",
          "aug.stno_segment_augment_prob=0.0", "aug.spec_aug_prob=0.0")
# the loss tolerances of phases 20-21. The micro-batches before the first
# update are a forward of the same rows and weights: DP_FORWARD_TOL
# (relative; they have come out bit-identical at micro-batch 2 and 4). The
# later ones: DP_LOSS_FACTOR times the largest relative difference of two
# unwrapped runs in this process (the bf16 backward's dq is not
# bit-reproducible and Adam carries its noise into the later losses; one
# pair samples that spread once, and ranks at micro-batch 2 also sum their
# weight gradients in another order), at least DP_LOSS_FLOOR
DP_FORWARD_TOL = 1e-5
DP_LOSS_FACTOR, DP_LOSS_FLOOR = 10.0, 1e-6
# phases 21 and 26: runs in this process with each micro-batch split as two
# data-parallel ranks split it, the reference of those phases; their pairs
# and the unwrapped pair sample the tolerance. At DP_LAYERS that tolerance
# has read above the split's own effect (2.70e-4 against 2.26e-4: PERF.md
# §6), so a rank must also be nearer these runs than the unwrapped run
DP_SPLIT_RUNS = 3
# phases 23-24, before the first update: the row-parallel projections add
# their partial products (formed and all-reduced in fp32) in another order
# than one GEMM, so a rare bf16 output rounds the other way; after it the
# phase-20 rule (10 x the unwrapped pair's spread, at least 1e-6). Fixed
# before the first run on the card (PERF.md §6)
TP_FORWARD_TOL = 1e-4
# phase 24's reduced SE-DiCoW: 4 encoder layers, 2 SCBs. Its spread is
# sampled by 4 unwrapped runs (the largest difference of their 6 pairs):
# with 4 layers the run-to-run order of dq moves a pair by 8.6e-6 in one
# call and 1.4e-4 in the next, while the data-parallel split (each data
# coordinate's weight gradients rounded to bf16 over its 2 rows) moves the
# losses by up to 5.1e-4 (PERF.md §6): the TP run is held to a DDP run on
# the same split after the first update
TP_SE_LAYERS, TP_SE_SCBS, TP_SE_RUNS = 4, 2, 4
# phases 20-23, 25, 26 and 28's [2] launch run the turbo width at DP_LAYERS
# encoder layers: at full depth FSDP2's all-gathers over gloo (12.6 GB a
# micro-batch and rank) took 31-45 s an update, and every launch's export
# (3.2 GB) counted against the machine's bound on disk writes, which a run
# crossed (PERF.md §6)
DP_LAYERS = 8
# phase 25: phase 20's fine-tune with LoRA, cut to 4 micro-batches with no
# preheat (2 updates, the adapters training from the first); its
# tolerance from the spread of 4 unwrapped runs of the same model, as
# phase 24's (a pair's spread moved 20x between two calls, 8.6e-6 to
# 1.7e-4: PERF.md §6)
LORA_FSDP_STEPS, LORA_FSDP_RUNS = 4, 4
# phase 26: rank 1's memory cap (GiB; torch.cuda.
# set_per_process_memory_fraction of the card's), between the memory
# probe's peak at micro-batch 2 (8.65 GiB allocated, 9.35 reserved) and at
# 4 (11.69 allocated) on a rank of two DDP ranks sharing the card, at
# DP_LAYERS encoder layers with labels 448 wide (PERF.md §6): the
# phase prints both
AUTOBATCH_CAP_GIB = 10.5
# phase 28: auto_find_batch_size under FSDP2 on ranks sharing the card over
# gloo, from micro-batch 4: (tag, encoder layers at full width, mesh, the
# capped rank, its cap in GiB). Each cap lies between that rank's memory
# probe at micro-batch 2 (its reserved peak, above the allocated one) and
# at 4 (its allocated peak), which the phase prints; uncapped on the card
# (PERF.md §6): [2] 6.26 GiB allocated, 8.19 reserved at 2, 8.99
# allocated at 4; [2, 2] 5.43 and 7.26 at 2, 9.02 at 4
AUTOBATCH_SHARDED = (
    ("dicow_v3_train_autobatch_fsdp_gloo_2ranks", DP_LAYERS, (2,), 1,
     8.6),
    ("dicow_v3_train_autobatch_fsdp_tp_2x2", TP_SE_LAYERS, (2, 2), 3, 8.1))
# 2 micro-batches at (2, 2) after the halving: one base update (4 steps,
# a preheat update and a base one, took 86 s of the run's 1,000)
AUTOBATCH_SHARDED_STEPS = 2
# the memory a rank allocates after the model's rebuild against when the
# first attempt started: the failed attempt's shards, optimizer state and
# activations must be gone; what the first attempt's kernels leave cached
# (cuBLAS workspaces) may remain
REBUILD_SLACK_GIB = 0.25
# wall-time limit of one torchrun launch of phases 20-26 and 28
CHILD_TIMEOUT = 420
# the flash forward's device time after the last training phase against
# phase 3's, at most this factor apart either way
DEVICE_TIME_GATE = 1.5
# phase 27: the tools' wall-time limit each, and profile_decode's stage
# lines (its JAX script's labels), each with a device reading
TOOL_TIMEOUT = 600
DECODE_STAGES = ("mel (batch", "window slice (batch", "encoder (batch",
                 "greedy loop", "loop no-CTC", "loop +CTC",
                 "longform greedy e2e [host feats]",
                 "longform greedy e2e [device feats]")


def mark(t_start: float, done: str) -> None:
    log(f"[time] {time.perf_counter() - t_start:.0f} s since the start, "
        f"after {done}")


def log(msg: str) -> None:
    print(msg, flush=True)


def median_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def fmt_ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


def bound(flop: float, nbytes: float, dtype=torch.bfloat16) -> dict:
    """The least time the card could take: the larger of the operations
    over the peak rate for their type and the bytes over the memory rate."""
    t_ops = flop / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def sdpa_fwd(q, k, v):
    """F.scaled_dot_product_attention with the port's pre-scaled q: the
    yardstick of the flash kernels, never called by the port."""
    return torch.nn.functional.scaled_dot_product_attention(q, k, v,
                                                            scale=1.0)


def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    log(smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    if not torch.cuda.is_available():
        log("no CUDA device: this script runs only on the GPU")
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.cuda.get_device_name(0)


def phase_build() -> None:
    from ts_asr_whisper_tpu_torch import kernels

    sources = sorted({kernels.KERNEL_SOURCES[k] for k in KERNELS})
    t0 = time.perf_counter()
    kernels.build_all(sources)
    log(f"[build] {len(sources)} sources ({len(KERNELS)} kernels) in "
        f"parallel: {time.perf_counter() - t0:.1f} s")
    for name in sources:
        getattr(kernels, f"{name}_lib")()
        info = kernels.build_info[name]
        log(f"[build] {name}.cu -> sm_90a in {info['seconds']:.1f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")


def share(bound_ms: float, ms) -> str:
    return "not measured" if ms is None else f"{100 * bound_ms / ms:.1f}%"


def phase_kernel(dev) -> dict:
    """The forward kernel vs flash_mha_reference, output and row
    log-sum-exp, at the encoder's shapes; times with CUDA events (per call)
    and torch.profiler (device) beside F.scaled_dot_product_attention's."""
    from ts_asr_whisper_tpu_torch.ops import attention as A

    gen = torch.Generator(device=dev).manual_seed(0)
    main = {}
    cases = [(ENC_SHAPE, dt) for dt in (torch.bfloat16, torch.float32)]
    cases += [((16, 20, t, 64), dt) for t in RAGGED_T
              for dt in (torch.bfloat16, torch.float32)]
    for shape, dt in cases:
        q, k, v = (torch.randn(shape, device=dev, generator=gen) * s
                   for s in (0.125, 1.0, 1.0))
        q, k, v = (x.to(dt) for x in (q, k, v))
        out, lse = A.flash_mha_fwd(q, k, v, with_lse=True)
        out_nolse = A.flash_mha_fwd(q, k, v)
        ref, ref_lse = A.flash_mha_reference(q, k, v, with_lse=True)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        atol, rtol = TOLS[dt]
        ok = (torch.allclose(out.float(), ref.float(), atol=atol, rtol=rtol)
              and torch.allclose(lse, ref_lse, atol=LSE_TOL, rtol=LSE_TOL)
              and torch.equal(out, out_nolse))
        del ref, ref_lse, out_nolse
        ms = median_ms(lambda: A.flash_mha_fwd(q, k, v))
        plain_ms = median_ms(lambda: A.flash_mha_reference(q, k, v), reps=5)
        flop = 4 * shape[0] * shape[1] * shape[2] ** 2 * shape[3]
        log(f"[kernel] {tuple(shape)} {str(dt)[6:]}: max_abs_err {err:.3e} "
            f"(atol {atol}, rtol {rtol}), lse {lse_err:.3e} (atol/rtol "
            f"{LSE_TOL}) kernel {ms:.3f} ms ({flop / ms / 1e9:.1f} TFLOP/s) "
            f"plain {plain_ms:.3f} ms")
        if not ok:
            raise AssertionError(f"kernel disagrees at {shape} {dt}")
        if shape == ENC_SHAPE and dt == torch.bfloat16:
            dev_ms = measure_device_ms(lambda: A.flash_mha_fwd(q, k, v))
            lib_ms = median_ms(lambda: sdpa_fwd(q, k, v))
            lib_dev_ms = measure_device_ms(lambda: sdpa_fwd(q, k, v))
            nbytes = 4 * q.numel() * q.element_size()  # q, k, v in, out
            main = {"max_abs_err": err, "lse_max_abs_err": lse_err, "ms": ms,
                    "device_ms": dev_ms, "plain_ms": plain_ms,
                    **bound(flop, nbytes), "library_ms": lib_ms,
                    "library_device_ms": lib_dev_ms}
            tflops = ("not measured" if dev_ms is None
                      else f"{flop / dev_ms / 1e9:.1f} TFLOP/s")
            log(f"[kernel] {tuple(shape)} bf16 main shape: device "
                f"{fmt_ms(dev_ms)} ({tflops}, {share(main['bound_ms'], dev_ms)}"
                f" of the bound {main['bound_ms']:.4f} ms, "
                f"{main['bound_by']}); F.scaled_dot_product_attention "
                f"{lib_ms:.3f} ms per call, device {fmt_ms(lib_dev_ms)} "
                f"({share(main['bound_ms'], lib_dev_ms)} of the bound)")
        del q, k, v, out, lse
    torch.cuda.empty_cache()
    return main


def phase_flash_bwd(dev) -> dict:
    """The backward kernel vs flash_mha_bwd_reference at the fine-tune's
    shapes, both fed the kernel forward's (out, lse); then FlashMHA (kernel
    forward and backward) against autograd through the plain forward,
    fp32."""
    from ts_asr_whisper_tpu_torch.ops import attention as A

    gen = torch.Generator(device=dev).manual_seed(6)
    b, h, _, d = BWD_SHAPE
    main = {}
    for t in BWD_T:
        for dt in (torch.bfloat16, torch.float32):
            q, k, v, g = (torch.randn(b, h, t, d, device=dev, generator=gen)
                          * s for s in (0.125, 1.0, 1.0, 1.0))
            q, k, v, g = (x.to(dt) for x in (q, k, v, g))
            o, lse = A.flash_mha_fwd(q, k, v, with_lse=True)
            args = (q, k, v, o, lse, g)
            out = A.flash_mha_bwd(*args)
            ref = A.flash_mha_bwd_reference(*args)
            torch.cuda.synchronize()
            errs, rels, ok = [], [], True
            for x, r in zip(out, ref):
                x, r = x.float(), r.float()
                errs.append((x - r).abs().max().item())
                rels.append(((x - r).norm() / r.norm()).item())
                if dt == torch.float32:
                    ok = ok and torch.allclose(x, r, atol=BWD_F32_TOL,
                                               rtol=BWD_F32_TOL)
                else:
                    ok = ok and rels[-1] <= BWD_BF16_REL
            ok = ok and all(x.dtype == dt for x in out)
            del ref
            tol = (f"atol/rtol {BWD_F32_TOL}" if dt == torch.float32
                   else f"Frobenius rel <= {BWD_BF16_REL}")
            ms = median_ms(lambda: A.flash_mha_bwd(*args))
            plain_ms = median_ms(lambda: A.flash_mha_bwd_reference(*args),
                                 reps=5)
            flop = 10 * b * h * t * t * d
            log(f"[flash_bwd] ({b}, {h}, {t}, {d}) {str(dt)[6:]}: dq/dk/dv "
                f"max_abs_err {', '.join(f'{e:.3e}' for e in errs)}, "
                f"Frobenius rel {', '.join(f'{r:.3e}' for r in rels)} "
                f"({tol}) kernel {ms:.3f} ms ({flop / ms / 1e9:.1f} TFLOP/s) "
                f"plain {plain_ms:.3f} ms")
            if not ok:
                raise AssertionError(f"backward kernel disagrees at T {t} "
                                     f"{dt}")
            if t == BWD_SHAPE[2] and dt == torch.bfloat16:
                dev_ms = measure_device_ms(lambda: A.flash_mha_bwd(*args))
                qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))
                lib_out = sdpa_fwd(qr, kr, vr)

                def lib_bwd():
                    torch.autograd.grad(lib_out, (qr, kr, vr), g,
                                        retain_graph=True)

                lib_ms = median_ms(lib_bwd)
                lib_dev_ms = measure_device_ms(lib_bwd)
                # q k v g out and lse in, dq dk dv out
                nbytes = (8 * q.numel() * q.element_size()
                          + lse.numel() * lse.element_size())
                main = {"max_abs_err": max(errs), "frobenius_rel": max(rels),
                        "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                        **bound(flop, nbytes), "library_ms": lib_ms,
                        "library_device_ms": lib_dev_ms}
                tflops = ("not measured" if dev_ms is None
                          else f"{flop / dev_ms / 1e9:.1f} TFLOP/s")
                log(f"[flash_bwd] bf16 main shape: device {fmt_ms(dev_ms)} "
                    f"({tflops}, {share(main['bound_ms'], dev_ms)} of the "
                    f"bound {main['bound_ms']:.4f} ms, {main['bound_by']}); "
                    f"F.scaled_dot_product_attention backward {lib_ms:.3f} "
                    f"ms per call, device {fmt_ms(lib_dev_ms)} "
                    f"({share(main['bound_ms'], lib_dev_ms)} of the bound)")
                del qr, kr, vr, lib_out
            del q, k, v, g, o, lse, args, out

    # FlashMHA end to end (forward and backward kernels) vs autograd
    # through the plain forward, fp32
    q, k, v, w = (torch.randn(BWD_SHAPE, device=dev, generator=gen) * s
                  for s in (0.125, 1.0, 1.0, 1.0))
    grads = []
    for fwd in (A.FlashMHA.apply, A.flash_mha_reference):
        xs = [x.detach().requires_grad_() for x in (q, k, v)]
        (fwd(*xs) * w).sum().backward()
        grads.append([x.grad for x in xs])
    torch.cuda.synchronize()
    err = max((a - r).abs().max().item() for a, r in zip(*grads))
    log(f"[flash_bwd] FlashMHA vs autograd through the plain forward, fp32 "
        f"{BWD_SHAPE}: max_abs_err {err:.3e} (atol/rtol {BWD_F32_TOL})")
    if not all(torch.allclose(a, r, atol=BWD_F32_TOL, rtol=BWD_F32_TOL)
               for a, r in zip(*grads)):
        raise AssertionError("FlashMHA gradients disagree with autograd")
    del q, k, v, w, grads
    torch.cuda.empty_cache()
    return main


def beam_hist(seed: int, t: int, dev) -> torch.Tensor:
    """(10, T) int32 ancestry map as a beam search of batch 2 x 5 beams
    builds it (ops/beam_attention.py::beam_search_history): beams share
    prefixes."""
    import numpy as np
    from ts_asr_whisper_tpu_torch.ops.beam_attention import \
        beam_search_history

    return torch.from_numpy(beam_search_history(
        np.random.default_rng(seed), AUDIO_ROWS, BEAMS, t)).to(dev)


def ancestry_inputs(dev, t: int, dt, gen, hist=None) -> list:
    """q/k_new/v_new (10, 20, 1, 64), one layer's cache (10, 20, T, 64) in
    ``dt`` and hist (10, T) int32: drawn uniformly, or as given."""
    bb, h = AUDIO_ROWS * BEAMS, TURBO["decoder_attention_heads"]
    q = torch.randn(bb, h, 1, 64, device=dev, generator=gen) / 8
    k_new, v_new = (torch.randn(bb, h, 1, 64, device=dev, generator=gen)
                    for _ in range(2))
    ck, cv = (torch.randn(bb, h, t, 64, device=dev, generator=gen)
              for _ in range(2))
    if hist is None:
        hist = torch.randint(0, BEAMS, (bb, t), device=dev, generator=gen,
                             dtype=torch.int32)
    return [x.to(dt) for x in (q, k_new, v_new, ck, cv)] + [hist]


def ancestry_bound(args, pos: int) -> dict:
    """The K/V rows before pos of one layer's cache, the new K/V, q and out,
    the ancestor rows; ~1 FLOP per byte."""
    bb, h, _, hd = args[0].shape
    item = args[0].element_size()
    nbytes = (2 * bb * h * pos * hd * item + 4 * bb * h * hd * item
              + args[5].numel() * 4)
    return bound(4 * bb * h * (pos + 1) * hd, nbytes, args[0].dtype)


def check_ancestry(args, pos, tag: str) -> float:
    """The kernel against its plain version on ``args`` at ``pos`` (an int
    or a device int32); returns the max abs error, raises past ANC_TOLS."""
    from ts_asr_whisper_tpu_torch.ops import beam_attention as BA

    out = BA.ancestry_attention(*args, pos, BEAMS)
    ref = BA.ancestry_attention_reference(*args, pos, BEAMS)
    torch.cuda.synchronize()
    dt = args[0].dtype
    err = (out.float() - ref.float()).abs().max().item()
    atol, rtol = ANC_TOLS[dt]
    if out.dtype != dt or not torch.allclose(out.float(), ref.float(),
                                             atol=atol, rtol=rtol):
        raise AssertionError(f"ancestry kernel disagrees: {tag} "
                             f"(max_abs_err {err:.3e})")
    return err


def ancestry_graph_replay(args, positions) -> float:
    """One ancestry launch captured in a CUDA graph with pos in a device
    int32, replayed at each of ``positions`` against the plain version;
    returns the max abs error."""
    from ts_asr_whisper_tpu_torch.ops import beam_attention as BA

    pos = torch.zeros(1, dtype=torch.int32, device=args[0].device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        BA.ancestry_attention(*args, pos, BEAMS)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = BA.ancestry_attention(*args, pos, BEAMS)
    atol, rtol = ANC_TOLS[args[0].dtype]
    worst = 0.0
    for p in positions:
        pos.fill_(p)
        graph.replay()
        ref = BA.ancestry_attention_reference(*args, p, BEAMS)
        torch.cuda.synchronize()
        worst = max(worst, (out.float() - ref.float()).abs().max().item())
        if not torch.allclose(out.float(), ref.float(), atol=atol, rtol=rtol):
            raise AssertionError(f"ancestry graph replay disagrees at pos {p}")
    del graph
    return worst


def phase_ancestry(dev) -> dict:
    """Ancestry beam attention vs its plain version at the beam step's
    shapes: q/k_new/v_new (10, 20, 1, 64), one layer's cache (10, 20, T, 64),
    uniform group-local ancestors at every class of pos, then a beam
    search's own ancestry map, then one launch captured in a CUDA graph and
    replayed at three device positions; L2 is warm (one layer's K/V <= 11.5
    MB)."""
    from ts_asr_whisper_tpu_torch.ops import beam_attention as BA

    gen = torch.Generator(device=dev).manual_seed(4)
    bb, h = AUDIO_ROWS * BEAMS, TURBO["decoder_attention_heads"]
    main = {}
    for t in ANC_T:
        for pos in (0, 1, t // 2, t - 1):
            for dt in (torch.bfloat16, torch.float32):
                args = ancestry_inputs(dev, t, dt, gen)
                err = check_ancestry(args, pos, f"T {t} pos {pos} {dt}")
                ms = median_ms(lambda: BA.ancestry_attention(*args, pos,
                                                             BEAMS), reps=20)
                plain_ms = median_ms(
                    lambda: BA.ancestry_attention_reference(*args, pos, BEAMS),
                    reps=20)
                dev_ms = measure_device_ms(
                    lambda: BA.ancestry_attention(*args, pos, BEAMS))
                plain_dev_ms = measure_device_ms(
                    lambda: BA.ancestry_attention_reference(*args, pos, BEAMS))
                atol, rtol = ANC_TOLS[dt]
                log(f"[ancestry] Bb {bb} H {h} T {t} pos {pos} "
                    f"{str(dt)[6:]}: max_abs_err {err:.3e} (atol {atol}, "
                    f"rtol {rtol}) per call: kernel {ms:.4f} ms plain "
                    f"{plain_ms:.4f} ms; device: kernel {fmt_ms(dev_ms)} "
                    f"plain {fmt_ms(plain_dev_ms)}")
                if (t, pos, dt) == ANC_MAIN:
                    main = {"max_abs_err": err, "ms": ms,
                            "plain_ms": plain_ms, "device_ms": dev_ms,
                            "plain_device_ms": plain_dev_ms,
                            **ancestry_bound(args, pos), "library_ms": None}
    # a beam search's own ancestry map: beams share prefixes, so the rows a
    # (hypothesis, head) reads come from few slabs
    t, pos, dt = ANC_MAIN
    for d in (torch.bfloat16, torch.float32):
        args = ancestry_inputs(dev, t, d, gen, hist=beam_hist(4, t, dev))
        errs = [check_ancestry(args, p, f"beam history T {t} pos {p} {d}")
                for p in (0, 1, pos, t - 1)]
        replay = ancestry_graph_replay(args, ANC_REPLAY)
        log(f"[ancestry] beam-search history, T {t} {str(d)[6:]}: "
            f"max_abs_err {max(errs):.3e} at pos 0, 1, {pos}, {t - 1}; one "
            f"launch captured in a CUDA graph, replayed at device pos "
            f"{', '.join(map(str, ANC_REPLAY))}: max_abs_err {replay:.3e}")
        if d == dt:
            hist_dev_ms = measure_device_ms(
                lambda: BA.ancestry_attention(*args, pos, BEAMS))
            main["beam_history_device_ms"] = hist_dev_ms
            main["graph_replay_max_abs_err"] = replay
    dev_ms = main["device_ms"]
    log(f"[ancestry] main shape Bb {bb} H {h} T {t} pos {pos} bf16: device "
        f"{fmt_ms(dev_ms)} ({share(main['bound_ms'], dev_ms)} of the bound "
        f"{main['bound_ms']:.4f} ms, {main['bound_by']}), "
        f"{fmt_ms(main['beam_history_device_ms'])} on a beam-search history;"
        f" per call {main['ms']:.4f} ms; the first design: device "
        f"{FIRST_DESIGN['ancestry_attn']}")
    return main


def psi_inputs(dev) -> dict:
    """The psi gather + dot's inputs at the beam step's shapes: the
    posterior's log-probs (2, 51867, 375) from blank-dominant CTC logits,
    10 hypotheses x 512 candidate slots from the rescorer's own candidate
    rule on tie-heavy scores, int32 audio rows (as init_ctc_state makes
    them), weights w that span the frames, and the rest of the prefix state
    ctc_psi_candidates takes."""
    from ts_asr_whisper_tpu_torch.decoding.ctc_rescorer import candidate_mask
    from ts_asr_whisper_tpu_torch.models.config import DiCoWConfig
    from ts_asr_whisper_tpu_torch.ops import psi_gather as PG
    from ts_asr_whisper_tpu_torch.ops.ctc_prefix import (initial_ctc_state,
                                                         psi_weights)

    cfg = DiCoWConfig(**TURBO)
    v_dec, blank, eos = cfg.vocab_size, cfg.vocab_size, cfg.eos_token_id
    ts_begin = cfg.timestamp_begin
    # the rescorer's candidate count and slots: 500 -> 512 at turbo
    k = min(500, ts_begin - 1)
    k_pad = -(-(k + 1) // 128) * 128
    bb = AUDIO_ROWS * BEAMS
    gen = torch.Generator(device=dev).manual_seed(5)
    logits = torch.randn(AUDIO_ROWS, CTC_T, v_dec + 1, device=dev,
                         generator=gen) * 2
    logits[..., blank] += BLANK_LOGIT
    logp = torch.log_softmax(logits, dim=-1)
    del logits
    audio_idx = torch.arange(bb, dtype=torch.int32, device=dev) // BEAMS
    r0, _ = initial_ctc_state(logp, blank)
    r = r0[audio_idx]
    r = r + 0.1 * torch.randn(r.shape, device=dev, generator=gen)
    decoded_len = torch.randint(0, 4, (bb,), device=dev, generator=gen)
    decoded_len[0] = 0
    last = torch.randint(10, ts_begin, (bb,), device=dev, generator=gen)
    scores = torch.log_softmax(
        torch.randn(bb, v_dec, device=dev, generator=gen) * 3, dim=-1)
    scores[-1, 100:700] = scores[-1].max()    # 600 exact ties for 500 slots
    mask = candidate_mask(scores, k, eos, ts_begin)
    mask[1, last[1]] = True                   # the last-label correction
    popcount = int(mask.sum(dim=1).max())
    if popcount > k_pad:
        raise AssertionError(f"{popcount} candidates > {k_pad} slots")
    logp_vt = logp.transpose(1, 2).contiguous()
    del logp
    w, _, _ = psi_weights(r, decoded_len)
    span = int((w > 1e-3 * w.amax(dim=1, keepdim=True)).sum(dim=1).min())
    if span < W_SPAN:
        raise AssertionError(f"psi weights span {span} frames < {W_SPAN}: "
                             "the sums would not test every frame")
    return {"logp_vt": logp_vt, "mask": mask, "audio_idx": audio_idx,
            "x_last": logp_vt[audio_idx, last], "r": r,
            "decoded_len": decoded_len, "last": last, "eos": eos,
            "k_pad": k_pad, "ids": PG.extract_topk_ids(mask, k_pad), "w": w,
            "popcount": popcount, "span": span, "v_dec": v_dec}


def psi_bound(p_vt, ids, w) -> dict:
    """The gathered candidate rows (each read once), w, the sums."""
    nbytes = (ids.numel() * CTC_T * p_vt.element_size() + w.numel() * 4
              + ids.numel() * 4)
    return bound(2 * ids.numel() * CTC_T, nbytes, p_vt.dtype)


def phase_psi(dev) -> dict:
    """The psi gather + dot vs its plain version at the beam step's shapes
    (psi_inputs). The sums are of positive terms, so they are held at a
    relative 2e-5 (a fixed atol would pass anything at sums of ~1e-6). Then
    the psi values it feeds (ctc_psi_candidates) on the card vs the CPU's
    plain path: same sparsity, live values at 2e-5. Then one call captured
    in a CUDA graph and replayed on new weights. L2 is warm for the
    timings."""
    from ts_asr_whisper_tpu_torch.ops import psi_gather as PG
    from ts_asr_whisper_tpu_torch.ops.ctc_prefix import LOG_ZERO

    c = psi_inputs(dev)
    audio_idx, ids, w, eos, k_pad = (c[k] for k in ("audio_idx", "ids", "w",
                                                     "eos", "k_pad"))
    state = [c[k] for k in ("mask", "audio_idx", "x_last", "r",
                            "decoded_len", "last")]
    cpu = [x.cpu() for x in state]
    main = {}
    for dt in (torch.float32, torch.bfloat16):
        p_vt = PG.padded_posterior(torch.exp(c["logp_vt"]), dt)
        vals = PG.psi_gather_dot(p_vt, audio_idx, ids, w)
        ref = PG.psi_gather_dot_reference(p_vt, audio_idx, ids, w)
        torch.cuda.synchronize()
        err = (vals - ref).abs().max().item()
        rel = ((vals - ref).abs() / ref.abs().clamp_min(1e-30)).max().item()
        ok = torch.allclose(vals, ref, atol=0.0, rtol=PSI_TOL)
        psi = PG.ctc_psi_candidates(p_vt, *state, eos, k_pad).cpu()
        psi_ref = PG.ctc_psi_candidates(p_vt.cpu(), *cpu, eos, k_pad)
        live = psi_ref > LOG_ZERO / 2
        same_live = torch.equal(psi > LOG_ZERO / 2, live)
        psi_err = (psi[live] - psi_ref[live]).abs().max().item()
        ok = ok and same_live and torch.allclose(
            psi[live], psi_ref[live], atol=PSI_TOL, rtol=PSI_TOL)
        # one call captured in a CUDA graph, replayed on new weights
        w_in = w.clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            PG.psi_gather_dot(p_vt, audio_idx, ids, w_in)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            replayed = PG.psi_gather_dot(p_vt, audio_idx, ids, w_in)
        w_in.copy_(w.flip(0))
        graph.replay()
        replay_ref = PG.psi_gather_dot_reference(p_vt, audio_idx, ids, w_in)
        torch.cuda.synchronize()
        ok = ok and torch.allclose(replayed, replay_ref, atol=0.0,
                                   rtol=PSI_TOL)
        del graph
        ms = median_ms(lambda: PG.psi_gather_dot(p_vt, audio_idx, ids, w),
                       reps=20)
        plain_ms = median_ms(
            lambda: PG.psi_gather_dot_reference(p_vt, audio_idx, ids, w),
            reps=20)
        dev_ms = measure_device_ms(
            lambda: PG.psi_gather_dot(p_vt, audio_idx, ids, w))
        plain_dev_ms = measure_device_ms(
            lambda: PG.psi_gather_dot_reference(p_vt, audio_idx, ids, w))
        log(f"[psi] P (2, {c['v_dec'] + 1}, {CTC_T}) {str(dt)[6:]}, ids "
            f"{tuple(ids.shape)}, popcount <= {c['popcount']}: sums "
            f"max_abs_err {err:.3e} (sums {ref.min().item():.3e} to "
            f"{ref.max().item():.3e}, max rel err {rel:.3e}, rtol {PSI_TOL}; "
            f"w spans >= {c['span']} of {CTC_T} frames), live psi max_abs_err "
            f"{psi_err:.3e} vs the CPU path ({int(live.sum())} live, sparsity "
            f"{'equal' if same_live else 'DIFFERS'}; atol/rtol {PSI_TOL}); "
            f"graph replay on new w {'agrees' if ok else 'DISAGREES'}; per "
            f"call: kernel {ms:.4f} ms plain {plain_ms:.4f} ms; device: "
            f"kernel {fmt_ms(dev_ms)} plain {fmt_ms(plain_dev_ms)}")
        if not ok:
            raise AssertionError(f"psi kernel disagrees ({dt})")
        if dt == torch.float32:
            main = {"max_abs_err": err, "max_rel_err": rel, "ms": ms,
                    "plain_ms": plain_ms, "device_ms": dev_ms,
                    "plain_device_ms": plain_dev_ms,
                    **psi_bound(p_vt, ids, w), "library_ms": None}
        del p_vt
    log(f"[psi] main shape fp32: device {fmt_ms(main['device_ms'])} "
        f"({share(main['bound_ms'], main['device_ms'])} of the bound "
        f"{main['bound_ms']:.4f} ms, {main['bound_by']}); per call "
        f"{main['ms']:.4f} ms; the first design: device "
        f"{FIRST_DESIGN['psi_gather_dot']}")
    del c
    torch.cuda.empty_cache()
    return main


def _reorder_idx(kind: str, bb: int, gen) -> torch.Tensor:
    """One beam step's source rows: drawn with repeats within each group of
    BEAMS, the identity, or each group reversed."""
    base = torch.arange(bb, device=gen.device) // BEAMS * BEAMS
    if kind == "repeats":
        off = torch.randint(0, BEAMS, (bb,), device=gen.device, generator=gen)
        off[::BEAMS] = off[1::BEAMS]  # at least one repeat per group
    elif kind == "identity":
        off = torch.arange(bb, device=gen.device) % BEAMS
    else:
        off = BEAMS - 1 - torch.arange(bb, device=gen.device) % BEAMS
    return (base + off).to(torch.int32)


def phase_reorder(dev) -> dict:
    """The two KV-cache reorder kernels vs their plain versions, bit for bit
    (a copy: tolerance 0), then times at the beam step's shapes. The main
    shape is the decode's: (4, 10, 20, 128, 64) bf16, 13.1 MB, so L2 (50 MB)
    holds it between calls; at T 448 in fp32 (183.5 MB) it cannot. The bound
    counts the cache read once and written once, and idx."""
    from ts_asr_whisper_tpu_torch.ops import reorder as R

    gen = torch.Generator(device=dev).manual_seed(7)
    layers, h = TURBO["decoder_layers"], TURBO["decoder_attention_heads"]
    fns = {"bhtd": (R.reorder_bhtd, R.reorder_bhtd_reference, 1),
           "tbhd": (R.reorder_tbhd, R.reorder_tbhd_reference, 2)}
    main = {}
    for layout, (fn, ref_fn, dim) in fns.items():
        name = f"kv_reorder_{layout}"
        for t, bb in REORDER_CASES:
            for dt in (torch.bfloat16, torch.float32):
                shape = ((layers, bb, h, t, 64) if layout == "bhtd"
                         else (layers, t, bb, h, 64))
                cache = torch.randn(shape, device=dev,
                                    generator=gen).to(dt)
                errs = []
                for kind in REORDER_KINDS:
                    idx = _reorder_idx(kind, bb, gen)
                    out = fn(cache, idx)
                    ref = ref_fn(cache, idx)
                    torch.cuda.synchronize()
                    if not torch.equal(out, ref):
                        raise AssertionError(
                            f"{name} disagrees with its plain version "
                            f"at {shape} {dt} ({kind})")
                    errs.append((out.float() - ref.float()).abs().max()
                                .item())
                idx = _reorder_idx("repeats", bb, gen)
                ms = median_ms(lambda: fn(cache, idx), reps=50)
                dev_ms = measure_device_ms(lambda: fn(cache, idx))
                plain_ms = median_ms(lambda: ref_fn(cache, idx), reps=50)
                lib_ms = median_ms(
                    lambda: torch.index_select(cache, dim, idx), reps=50)
                lib_dev_ms = measure_device_ms(
                    lambda: torch.index_select(cache, dim, idx))
                nbytes = 2 * cache.numel() * cache.element_size() + bb * 4
                b = bound(0.0, nbytes, dt)
                log(f"[reorder] {layout} {tuple(shape)} {str(dt)[6:]}: "
                    f"equal bit for bit ({', '.join(REORDER_KINDS)}); "
                    f"per call: kernel {ms:.4f} ms plain {plain_ms:.4f} "
                    f"ms index_select {lib_ms:.4f} ms; device: kernel "
                    f"{fmt_ms(dev_ms)} index_select {fmt_ms(lib_dev_ms)}; "
                    f"bound {b['bound_ms']:.4f} ms ({nbytes / 1e6:.1f} "
                    f"MB)")
                if (t, bb, dt) == (*REORDER_CASES[0], torch.bfloat16):
                    main[name] = {"max_abs_err": max(errs), "ms": ms,
                                  "device_ms": dev_ms,
                                  "plain_ms": plain_ms, **b,
                                  "library_ms": lib_ms,
                                  "library_device_ms": lib_dev_ms}
                del cache
    torch.cuda.empty_cache()
    return main


def optim_leaves(dev) -> dict:
    """The dicow_v3 cell's trained leaves at turbo width, fp32 on the card
    (label -> parameters, as build_optimizer groups them): the model built
    on the meta device for its names and shapes, labelled as the fine-tune
    labels them (decoder frozen), the values drawn from a fixed seed."""
    from ts_asr_whisper_tpu_torch.config import load_config
    from ts_asr_whisper_tpu_torch.models.config import make_config
    from ts_asr_whisper_tpu_torch.models.dicow import DiCoW
    from ts_asr_whisper_tpu_torch.training.optim import param_labels

    with torch.device("meta"):
        model = DiCoW(make_config("large-v3-turbo", **OPTIM_MODEL))
    labels = param_labels(model, load_config(
        [], n_devices=1).model.prefixes_to_preheat, ["decoder"], False)
    gen = torch.Generator(device=dev).manual_seed(11)
    groups = {}
    for name, p in model.named_parameters():
        if labels[name] != "frozen":
            groups.setdefault(labels[name], []).append(torch.nn.Parameter(
                torch.randn(p.shape, device=dev, generator=gen) * 0.02))
    return groups


def phase_optimizer(dev) -> dict:
    """The fine-tune's multi-tensor kernels at the dicow_v3 cell's trained
    leaf set (optim_leaves): sq_norm_multi against _sq_sum (within
    OPTIM_NORM_RTOL, the same bits twice), adamw_multi against AdamW's
    per-leaf loop on the card after two updates with the clip on, bit for
    bit; then times with CUDA events (per call) and torch.profiler
    (device) beside the plain versions and, as yardsticks the port never
    calls, torch.optim.AdamW(fused=True) and torch._foreach_norm. The
    bounds count bytes: the update reads p, g, m, v and writes p, m, v (28
    bytes a fp32 parameter), the norm reads each gradient once."""
    import dataclasses

    from ts_asr_whisper_tpu_torch.config import load_config
    from ts_asr_whisper_tpu_torch.training.optim import AdamW
    from ts_asr_whisper_tpu_torch.utils.observability import (_sq_sum,
                                                               global_norm)

    t0 = time.perf_counter()
    groups = optim_leaves(dev)
    twins = {k: [torch.nn.Parameter(p.detach().clone()) for p in v]
             for k, v in groups.items()}
    # dicow_v3's optimizer settings over base.yaml's
    cfg = dataclasses.replace(load_config([], n_devices=1).training,
                              learning_rate=2e-6, warmup_steps=0,
                              max_steps=40000, lr_scheduler_type="cosine")
    kernel = AdamW(groups, cfg, cfg.fddt_lr_multiplier)
    plain = AdamW(twins, cfg, cfg.fddt_lr_multiplier)
    plain.table = None  # the per-leaf loop, also on the card
    n = sum(p.numel() for p in kernel.params)
    gen = torch.Generator(device=dev).manual_seed(12)
    grads = [torch.randn(p.shape, device=dev, generator=gen) * 1e-3
             for p in kernel.params]
    g_norm = global_norm(grads)
    again = global_norm(grads)
    ref = _sq_sum(grads).sqrt()
    torch.cuda.synchronize()
    rel = abs(g_norm.item() - ref.item()) / ref.item()
    if rel > OPTIM_NORM_RTOL or not torch.equal(g_norm, again):
        raise AssertionError(f"sq_norm_multi: norm {g_norm.item()} against "
                             f"the plain {ref.item()} ({rel:.2e} apart), "
                             f"again {again.item()}")
    for _ in range(2):
        kernel.step(grads, g_norm=g_norm)
        plain.step(grads, g_norm=g_norm)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(kernel.params, plain.params)):
        if not (torch.equal(a, b) and torch.equal(kernel.mu[i], plain.mu[i])
                and torch.equal(kernel.nu[i], plain.nu[i])):
            raise AssertionError(f"adamw_multi disagrees with the loop at "
                                 f"leaf {i} {tuple(a.shape)}")
    log(f"[optim] {len(kernel.params)} trained leaves, {n / 1e6:.1f} M fp32 "
        f"parameters: norm {g_norm.item():.6f} (clip on, max "
        f"{cfg.max_grad_norm}), {rel:.2e} from the plain sum, the same bits "
        f"twice; two updates equal to the loop bit for bit")
    del twins
    step = lambda: kernel.step(grads, g_norm=g_norm)  # noqa: E731
    norm = lambda: global_norm(grads)  # noqa: E731
    ms, dev_ms = median_ms(step), measure_device_ms(step, reps=10)
    plain_ms = median_ms(lambda: plain.step(grads, g_norm=g_norm), reps=3,
                         warmup=1)
    del plain
    fused = torch.optim.AdamW(kernel.params, lr=2e-6, weight_decay=0.0,
                              eps=cfg.adam_epsilon, fused=True)
    for p, g in zip(kernel.params, grads):
        p.grad = g
    lib_ms = median_ms(fused.step)
    lib_dev_ms = measure_device_ms(fused.step, reps=10)
    del fused
    for p in kernel.params:
        p.grad = None
    adam = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            **bound(0.0, 28 * n, torch.float32), "library_ms": lib_ms,
            "library_device_ms": lib_dev_ms}
    n_ms, n_dev_ms = median_ms(norm), measure_device_ms(norm, reps=10)
    n_plain_ms = median_ms(lambda: _sq_sum(grads).sqrt(), reps=5)
    foreach = lambda: torch.linalg.vector_norm(  # noqa: E731
        torch.stack(torch._foreach_norm(grads)))
    n_lib_ms = median_ms(foreach)
    n_lib_dev_ms = measure_device_ms(foreach, reps=10)
    sq = {"rel_err": rel, "ms": n_ms, "device_ms": n_dev_ms,
          "plain_ms": n_plain_ms, **bound(0.0, 4 * n, torch.float32),
          "library_ms": n_lib_ms, "library_device_ms": n_lib_dev_ms}
    for name, r, lib in (("adamw_multi", adam, "AdamW(fused=True)"),
                         ("sq_norm_multi", sq, "_foreach_norm")):
        log(f"[optim] {name}: per call {r['ms']:.3f} ms, device "
            f"{fmt_ms(r['device_ms'])} ({share(r['bound_ms'], r['device_ms'])}"
            f" of the bound {r['bound_ms']:.3f} ms, {r['bound_by']}); plain "
            f"{r['plain_ms']:.3f} ms; {lib} {r['library_ms']:.3f} ms, device "
            f"{fmt_ms(r['library_device_ms'])}")
    log(f"[optim] phase {time.perf_counter() - t0:.1f} s")
    del kernel, grads, groups
    gc.collect()
    torch.cuda.empty_cache()
    return {"adamw_multi": adam, "sq_norm_multi": sq}


def phase_encoder(dev) -> None:
    from ts_asr_whisper_tpu_torch.models.config import DiCoWConfig
    from ts_asr_whisper_tpu_torch.models.dicow import build_dicow

    cfg = DiCoWConfig(**TURBO, dtype="float32", use_pre_pos_fddt=True,
                      fddt_init="random")
    model = build_dicow(cfg, dev, seed=0, flash=True)
    enc = model.encoder
    gen = torch.Generator(device=dev).manual_seed(1)
    feats = torch.randn(2, 128, 3000, device=dev, generator=gen)
    labels = torch.randint(0, 4, (2, 1500), device=dev, generator=gen)
    stno = torch.nn.functional.one_hot(labels, 4).transpose(1, 2).float()
    with torch.no_grad():
        out = enc(feats, stno)
        enc.flash = False
        ref = enc(feats, stno)
        enc.flash = True
    torch.cuda.synchronize()
    if out.shape != (2, 1500, 1280) or not torch.isfinite(out).all():
        raise AssertionError(f"encoder output {tuple(out.shape)} not finite")
    err = (out - ref).abs().max().item()
    log(f"[encoder] turbo fp32, 2 windows: max_abs_err kernel vs plain "
        f"{err:.3e} (atol {ENC_ATOL}), output max |x| "
        f"{out.abs().max().item():.2f}")
    if err > ENC_ATOL:
        raise AssertionError("encoder: kernel and plain attention disagree")

    # bf16 encoder at decode batch 16: kernel vs plain attention
    model.to(torch.bfloat16)
    model.cfg = enc.cfg = cfg.replace(dtype="bfloat16")
    feats = torch.randn(16, 128, 3000, device=dev, generator=gen)
    stno = stno[:1].expand(16, -1, -1)
    with torch.no_grad():
        t_kernel = median_ms(lambda: enc(feats, stno), reps=3, warmup=1)
        enc.flash = False
        t_plain = median_ms(lambda: enc(feats, stno), reps=3, warmup=1)
    log(f"[encoder] turbo bf16, 16 windows: kernel {t_kernel:.1f} ms "
        f"({16e3 / t_kernel:.1f} windows/s), plain attention {t_plain:.1f} ms "
        f"({16e3 / t_plain:.1f} windows/s)")
    del model, enc, feats, out, ref
    torch.cuda.empty_cache()


def run_decode(dev, tag: str, overrides, durations, gen_json=None) -> dict:
    """Drive the decode entry point (DecodeRunner) on a synthetic corpus at
    turbo width with random weights (and ``gen_json`` as the model dir's
    generation_config.json); the launch counts are set to 0 just before the
    run and read just after. Checks the output files, a finite tcp_wer, and
    that every encoder layer and every CTC-head call ran the flash
    kernel."""
    from ts_asr_whisper_tpu_torch import kernels
    from ts_asr_whisper_tpu_torch.config import load_config
    from ts_asr_whisper_tpu_torch.data.synthetic import write_corpus
    from ts_asr_whisper_tpu_torch.decode import DecodeRunner, scoring_backend
    from ts_asr_whisper_tpu_torch.decoding import beam
    from ts_asr_whisper_tpu_torch.models.dicow import DiCoWEncoder

    work = WORK / tag
    shutil.rmtree(work, ignore_errors=True)
    manifest = write_corpus(work / "corpus", durations, seed=0)
    model_dir = work / "model"
    model_dir.mkdir(parents=True)
    (model_dir / "config.json").write_text(json.dumps(TURBO))
    if gen_json is not None:
        (model_dir / "generation_config.json").write_text(
            json.dumps(gen_json))
    out_dir = work / "exp"
    cfg = load_config([
        *overrides,
        f"model.whisper_model={model_dir}",
        f"data.eval_cutsets=[{manifest}]",
        "training.generation_max_length=128",
        "training.save_visualizations=false",
        f"training.output_dir={out_dir}",
    ])
    t = cfg.training
    log(f"[{tag}] batch {t.per_device_eval_batch_size}, beams "
        f"{t.generation_num_beams}, decoding CTC weight "
        f"{cfg.decoding.decoding_ctc_weight}, length penalty "
        f"{cfg.decoding.length_penalty}, dtype {cfg.model.dtype}, max length "
        f"{t.generation_max_length}, timestamps {cfg.data.use_timestamps}")

    t0 = time.perf_counter()
    runner = DecodeRunner(cfg, dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    enc = runner.container.model.encoder
    calls = {"encoder": 0, "ctc_head": 0}

    def count_encoder(module, args, output):
        if isinstance(module, DiCoWEncoder):
            calls["encoder"] += 1

    ctc_logits = enc.ctc_logits

    def counted_ctc_logits(hidden):
        calls["ctc_head"] += 1
        return ctc_logits(hidden)

    enc.ctc_logits = counted_ctc_logits
    hook = torch.nn.modules.module.register_module_forward_hook(count_encoder)
    for name in kernels.launch_counts:
        kernels.launch_counts[name] = 0
    beam.counters["beam_steps"] = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        metrics = runner.run()
    finally:
        hook.remove()
        del enc.ctc_logits
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    steps = beam.counters["beam_steps"]

    name = "eval_cutset"
    csv_path = out_dir / f"test_{name}" / "step_0" / "all_session_wer.csv"
    hyps = list((out_dir / f"test_{name}").rglob("tcp_wer_hyp.json"))
    tcp = metrics.get(f"eval_{name}_tcp_wer")
    rows = len(runner.eval_datasets[name])
    audio_s = 2 * sum(durations)  # two target speakers per recording
    log(f"[{tag}] {rows} rows, {runner.windows_decoded} row-windows, "
        f"{calls['encoder']} encoder calls, {calls['ctc_head']} CTC-head "
        f"calls, {steps} beam steps, wall {wall:.1f} s "
        f"(+{setup_s:.1f} s model/data set-up), "
        f"{audio_s / wall:.1f} audio-s/s, "
        f"{runner.windows_decoded / wall:.2f} row-windows/s, "
        f"launches {launches}, peak mem "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB, "
        f"scoring {scoring_backend()}")
    log(f"[{tag}] metrics {metrics}")
    if not csv_path.exists() or len(hyps) != len(durations):
        raise AssertionError(f"{tag} outputs missing: {csv_path}, "
                             f"{len(hyps)} hypothesis files")
    if tcp is None or not math.isfinite(tcp):
        raise AssertionError(f"{tag}: no finite tcp_wer in {metrics}")
    if scoring_backend() != "native":
        from ts_asr_whisper_tpu_torch.eval import native

        raise AssertionError(f"{tag}: scored with the numpy fallback; "
                             f"native build: {native.build_log}")
    if rows != 2 * len(durations) or calls["encoder"] == 0:
        raise AssertionError(f"{tag}: {rows} rows, {calls['encoder']} "
                             "encoder calls")
    # every encoder layer's self-attention, every SCB's cross-attention
    # (SE-DiCoW) and the CTC head's bare self-attention run the kernel
    mc = runner.container.model_config
    per_call = mc.encoder_layers + (mc.scb_layers or 0) * mc.use_enrollments
    want = per_call * calls["encoder"] + calls["ctc_head"]
    if launches["flash_attn_fwd"] != want:
        raise AssertionError(
            f"{tag}: flash_attn_fwd launched {launches['flash_attn_fwd']} "
            f"times, want {want} ({per_call} x encoder calls + CTC-head "
            "calls)")
    return {"runner": runner, "launches": launches, "steps": steps,
            "calls": calls, "wall": wall, "hyps": sorted(hyps),
            "metrics": {k: float(v) for k, v in metrics.items()}}


def phase_decode(dev) -> dict:
    res = run_decode(dev, "greedy", ["+decode=dicow_v3_greedy"], [60.0] * 8)
    if any(res["launches"][k] for k in ("ancestry_attn", "psi_gather_dot",
                                        "kv_reorder_bhtd", "kv_reorder_tbhd")):
        raise AssertionError(f"greedy decode ran beam kernels: "
                             f"{res['launches']}")
    phase_decode_loop(res["runner"], dev)
    phase_int8_cross_kv(res["runner"], dev)
    return res["launches"]


def phase_decode_loop(runner, dev, steps: int = 125) -> None:
    """The greedy loop alone at batch 16, run to full length (no EOS exit)
    on random encoder states: ms per decode step, cross-KV included."""
    from ts_asr_whisper_tpu_torch.decoding.greedy import greedy_decode

    model = runner.container.model
    gen = torch.Generator(device=dev).manual_seed(2)
    enc = torch.randn(16, 1500, TURBO["d_model"], device=dev,
                      generator=gen).to(runner.container.model_config
                                        .compute_dtype)
    prompt = torch.tensor(runner.container.tokenizer.prefix_tokens[:3],
                          device=dev).repeat(16, 1)
    for _ in range(2):  # the first pass warms the allocator
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        greedy_decode(model, runner.gen_cfg, enc, prompt, steps,
                      force_full_length=True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    log(f"[decode] greedy loop alone, batch 16, {steps} steps to full "
        f"length: {dt * 1e3 / steps:.2f} ms/step ({dt:.2f} s)")
    del model, enc


def run_beam_decode(dev, tag: str, overrides, durations,
                    gen_json=None) -> dict:
    """A beam joint-CTC decode through the decode entry point (run_decode);
    the time inside beam_search (prefill and cross-KV included) gives ms per
    beam step. Checks that it was a beam joint-CTC decode whose every beam
    step launched the psi kernel once."""
    from ts_asr_whisper_tpu_torch.decoding import ctc_rescorer
    from ts_asr_whisper_tpu_torch.decoding import longform
    from ts_asr_whisper_tpu_torch.models.whisper import get_kv_cache_layout
    from ts_asr_whisper_tpu_torch.ops.reorder import get_reorder_impl

    beam_search = longform.beam_search
    beam_s = [0.0]

    def timed_beam_search(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = beam_search(*args, **kwargs)
        torch.cuda.synchronize()
        beam_s[0] += time.perf_counter() - t0
        return out

    gc.collect()  # the models of the phases before
    torch.cuda.empty_cache()
    longform.beam_search = timed_beam_search
    try:
        res = run_decode(dev, tag, overrides, durations, gen_json)
    finally:
        longform.beam_search = beam_search
    steps, launches = res["steps"], res["launches"]
    gen_cfg = res["runner"].gen_cfg
    res["ms_per_step"] = beam_s[0] * 1e3 / max(steps, 1)
    log(f"[{tag}] {steps} beam steps in {beam_s[0]:.2f} s of "
        f"beam_search: {res['ms_per_step']:.2f} ms per beam step (Bb "
        f"{AUDIO_ROWS * BEAMS}), reorder impl {get_reorder_impl(device=dev)},"
        f" cache layout {get_kv_cache_layout()}, psi path "
        f"{ctc_rescorer.resolve_psi_impl(gen_cfg.ctc_psi_impl, dev)}")
    if gen_cfg.num_beams != BEAMS or not gen_cfg.ctc_weight > 0:
        raise AssertionError(f"{tag}: not a beam joint-CTC decode: {gen_cfg}")
    if steps == 0 or res["calls"]["ctc_head"] == 0:
        raise AssertionError(f"{tag}: {steps} beam steps, "
                             f"{res['calls']['ctc_head']} CTC-head calls")
    if launches["psi_gather_dot"] != steps:
        raise AssertionError(f"{tag}: psi_gather_dot launched "
                             f"{launches['psi_gather_dot']} times, want "
                             f"{steps} (one per beam step)")
    return res


def phase_beam_decode(dev) -> dict:
    """dicow_v3_beam_joint on the default ('auto': the ancestry cache on the
    card) reorder path: the ancestry kernel in every decoder layer of every
    beam step, no reorder kernel."""
    res = run_beam_decode(dev, "beam_joint", ["+decode=dicow_v3_beam_joint",
                                              "model.ctc_weight=0.3"],
                          [60.0] * 4)
    steps, launches = res["steps"], res["launches"]
    layers = TURBO["decoder_layers"]
    if launches["kv_reorder_bhtd"] or launches["kv_reorder_tbhd"]:
        raise AssertionError(f"beam_joint: the ancestry path ran a reorder "
                             f"kernel: {launches}")
    if launches["ancestry_attn"] != layers * steps:
        raise AssertionError(f"ancestry_attn launched "
                             f"{launches['ancestry_attn']} times, want "
                             f"{layers * steps} ({layers} layers x {steps} "
                             "beam steps)")
    return res


SE_DICOW = ["+decode=se_dicow_beam_joint", f"model.scb_layers={SCB_LAYERS}",
            "model.use_enrollments=true", "data.use_enrollments=true",
            "data.enrollment_cutsets=[]", "model.ctc_weight=0.3"]


def phase_se_dicow(dev, layout: str, durations) -> dict:
    """se_dicow_beam_joint with self-enrollment (no enrollment cutsets: each
    row's enrollment is the 30 s of its recording where its speaker talks
    most) through the decode entry point, with the standalone-permute
    reorder ('pallas') on the ``layout`` cache: the layout's reorder kernel
    twice per beam step (k and v), the other reorder kernel and the ancestry
    kernel never. The reorder impl and the cache layout are restored."""
    from ts_asr_whisper_tpu_torch.models import whisper as W
    from ts_asr_whisper_tpu_torch.ops import reorder as R

    tag = f"se_dicow_beam_joint_{layout}"
    prev = (R.get_reorder_impl(raw=True), W.get_kv_cache_layout())
    R.set_reorder_impl("pallas")
    W.set_kv_cache_layout(layout)
    try:
        res = run_beam_decode(dev, tag, SE_DICOW, durations)
    finally:
        R.set_reorder_impl(prev[0])
        W.set_kv_cache_layout(prev[1])
    steps, launches = res["steps"], res["launches"]
    mc = res["runner"].container.model_config
    if not (mc.use_enrollments and mc.scb_layers == SCB_LAYERS) or len(
            res["runner"].container.model.encoder.ca_enrolls) != SCB_LAYERS:
        raise AssertionError(f"{tag}: not an SE-DiCoW model with "
                             f"{SCB_LAYERS} SCBs")
    other = "tbhd" if layout == "bhtd" else "bhtd"
    want = {f"kv_reorder_{layout}": 2 * steps, f"kv_reorder_{other}": 0,
            "ancestry_attn": 0}
    got = {k: launches[k] for k in want}
    log(f"[{tag}] encoder calls {res['calls']['encoder']} (each "
        f"{mc.encoder_layers} layers + {SCB_LAYERS} SCBs on 2 streams), "
        f"launches {got}, want {want}")
    if got != want:
        raise AssertionError(f"{tag}: launches {got}, want {want}")
    return res


def _snapshot(model) -> dict:
    return {n: p.detach().to("cpu", copy=True)
            for n, p in model.named_parameters()}


def _changed(a: dict, b: dict) -> set:
    return {n for n in a if not torch.equal(a[n], b[n])}


def phase_train(dev) -> dict:
    """+train=dicow_v3 through ModelTrainer, as the CLI drives it, on a
    synthetic corpus at turbo width with random weights. The launch counts
    are set to 0 just before the run and read just after."""
    from safetensors.torch import load_file

    from ts_asr_whisper_tpu_torch.config import load_config
    from ts_asr_whisper_tpu_torch.data.synthetic import write_corpus
    from ts_asr_whisper_tpu_torch.models.containers import WhisperContainer
    from ts_asr_whisper_tpu_torch.models.convert import normalize_state_dict
    from ts_asr_whisper_tpu_torch.train import ModelTrainer

    gc.collect()  # the decode phases' models
    torch.cuda.empty_cache()
    work = WORK / "train"
    shutil.rmtree(work, ignore_errors=True)
    manifest = write_corpus(work / "corpus", [30.0] * 8, seed=1)
    model_dir = _turbo_dir(work)
    out_dir = work / "exp"
    cfg = load_config(train_overrides(manifest, model_dir, out_dir))
    t = cfg.training
    k = t.gradient_accumulation_steps
    t0 = time.perf_counter()
    mt = ModelTrainer(cfg, dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    model, mc = mt.model, mt.container.model_config
    # flash calls per micro-batch: every encoder layer's self-attention and
    # the CTC head's bare self-attention (q_len = kv_len = 1500, no mask);
    # the decoder's attention is masked or cross, so it stays plain
    per_batch = mc.encoder_layers + int(
        mc.ctc_weight > 0 and (mc.additional_layer
                               or mc.additional_self_attention_layer))
    log(f"[train] dicow_v3: {len(mt.train_dataset)} rows, micro-batch "
        f"{t.per_device_train_batch_size}, accumulation {k}, "
        f"{t.max_steps} micro-batches ({t.use_fddt_only_n_steps} preheat), "
        f"dtype {mc.dtype} params {cfg.model.param_dtype}, CTC weight "
        f"{mc.ctc_weight}, gradient checkpointing "
        f"{t.gradient_checkpointing}, {per_batch} flash calls per "
        f"micro-batch; set-up {setup_s:.1f} s")

    snaps = {"start": _snapshot(model)}
    res = _run_trainer(mt, snaps)
    wall, launches, peak = res["wall"], res["launches"], res["peak"]
    phase_labels = res["labels"]
    snaps["end"] = _snapshot(model)

    recs = [json.loads(line) for line in
            (out_dir / "metrics.jsonl").read_text().splitlines()]
    losses = [r["loss"] for r in recs]
    updates = t.max_steps // k
    loop = res["loop"]
    log(f"[train] {t.max_steps} micro-batches, {updates} updates: training "
        f"loop {loop:.2f} s, {loop * 1e3 / updates:.0f} ms per optimizer "
        f"update, {loop / t.max_steps * 1e3:.0f} ms per micro-batch of "
        f"{t.per_device_train_batch_size} (first steps' warm-up and data "
        f"loading included); ModelTrainer.train {wall:.1f} s with the HF "
        f"export; peak mem {peak:.1f} GiB; launches {launches}")
    log(f"[train] losses {[round(x, 4) for x in losses]}, grad norms "
        f"{[round(r['grad_norm'], 4) for r in recs]}")
    if len(recs) != t.max_steps or not all(
            math.isfinite(r[key]) for r in recs
            for key in ("loss", "dec_loss", "ctc_loss", "grad_norm")):
        raise AssertionError(f"train: {len(recs)} logged steps, not all "
                             f"finite: {recs}")
    want = per_batch * t.max_steps
    if not launches["flash_attn_fwd"] == launches["flash_attn_bwd"] == want:
        raise AssertionError(
            f"train: flash launches fwd {launches['flash_attn_fwd']} bwd "
            f"{launches['flash_attn_bwd']}, want {want} ({per_batch} x "
            f"{t.max_steps} micro-batches)")
    # every update one launch of the multi-tensor AdamW (each phase's
    # trained leaves fit one table); the norm once a micro-batch (the
    # logged one) and once an update (the inner step's, under MultiSteps)
    if (launches["adamw_multi"], launches["sq_norm_multi"]) != (
            updates, t.max_steps + (updates if k > 1 else 0)):
        raise AssertionError(
            f"train: adamw_multi {launches['adamw_multi']} and "
            f"sq_norm_multi {launches['sq_norm_multi']} launches for "
            f"{updates} updates of {k} micro-batches")
    if set(phase_labels) != {"preheat", "base"}:
        raise AssertionError(f"train: phases seen {sorted(phase_labels)}")
    pre = {n for n, lab in phase_labels["preheat"].items()
           if lab == "preheat"}
    changed = _changed(snaps["start"], snaps["preheat"])
    if not changed or not changed <= pre:
        raise AssertionError(f"preheat changed {len(changed)} tensors, "
                             f"{sorted(changed - pre)[:5]} outside the "
                             f"{len(pre)} preheat tensors")
    changed = _changed(snaps["preheat"], snaps["end"])
    dec = {n for n in snaps["end"] if ".decoder." in n}
    base = {n for n, lab in phase_labels["base"].items() if lab == "base"}
    if changed & dec or not changed & base:
        raise AssertionError(f"base phase changed {len(changed & dec)} "
                             f"decoder tensors, {len(changed & base)} base "
                             "tensors")
    log(f"[train] preheat changed {len(_changed(snaps['start'], snaps['preheat']))}"
        f" of {len(pre)} preheat tensors and nothing else; base changed "
        f"{len(changed)} tensors ({len(changed & base)} base), decoder "
        f"({len(dec)} tensors) bit-identical")

    # the export loads strictly into the port's container and equals the
    # trained parameters
    del mt, model
    gc.collect()
    torch.cuda.empty_cache()
    export = out_dir / "hf_export"
    ecfg = load_config([f"model.whisper_model={export}",
                               "model.ctc_weight=0.3"])
    container = WhisperContainer(ecfg, dev)
    sd = normalize_state_dict(load_file(str(export / "model.safetensors")))
    loaded = dict(container.model.named_parameters())
    bad = [n for n, v in snaps["end"].items()
           if not torch.equal(loaded[n].detach().cpu(), v)]
    log(f"[train] hf_export: {len(sd)} tensors, loaded strictly into the "
        f"port's container, {len(loaded) - len(bad)} of {len(loaded)} "
        "parameters equal to the trained ones")
    if bad:
        raise AssertionError(f"hf_export differs from the trained model: "
                             f"{bad[:5]}")
    del container, snaps
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "ms_per_update": loop * 1e3 / updates,
            "peak_gib": peak}


def train_overrides(manifest, model_dir, out_dir) -> list:
    """Phase 9's fine-tune: +train=dicow_v3 without its env-var paths, a
    global batch of 8 rows in micro-batches of 8 / (world x 2) with
    accumulation 2, 8 micro-batches (4 preheat), no evals."""
    return ["+train=dicow_v3", f"model.whisper_model={model_dir}",
            "model.reinit_encoder_from=null",
            f"data.train_cutsets=[{manifest}]",
            "data.dev_cutsets=[]", "data.eval_cutsets=[]",
            "data.dataset_weights=null", "aug.musan_root=null",
            "training.overall_batch_size=8",
            "training.gradient_accumulation_steps=2", "training.max_steps=8",
            "training.use_fddt_only_n_steps=4", "training.warmup_steps=0",
            "training.eval_strategy=no", "training.save_strategy=no",
            "training.logging_steps=1", f"training.output_dir={out_dir}"]


def _turbo_dir(work: Path) -> Path:
    model_dir = work / "model"
    model_dir.mkdir(parents=True)
    (model_dir / "config.json").write_text(json.dumps(TURBO))
    return model_dir


def _watch_trainer(snaps: dict, phase_labels: dict, loop_s: list,
                   at_end=None):
    """Patch the Trainer to snapshot the parameters and labels at the
    unfreeze, time its loop and call ``at_end(trainer)`` when the loop
    ends; returns the function that restores it."""
    from ts_asr_whisper_tpu_torch.training import trainer as trainer_mod

    unfreeze = trainer_mod.Trainer._maybe_unfreeze
    train_loop = trainer_mod.Trainer.train

    def watched_unfreeze(self):
        phase = self.state.phase
        if phase == "preheat":
            phase_labels["preheat"] = dict(self.labels)
        unfreeze(self)
        if phase == "preheat" and self.state.phase == "base":
            torch.cuda.synchronize()
            snaps["preheat"] = _snapshot(self.model)
            phase_labels["base"] = dict(self.labels)

    def timed_loop(self, it):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = train_loop(self, it)
        torch.cuda.synchronize()
        loop_s.append(time.perf_counter() - t1)
        if at_end is not None:
            at_end(self)
        return out

    trainer_mod.Trainer._maybe_unfreeze = watched_unfreeze
    trainer_mod.Trainer.train = timed_loop

    def restore():
        trainer_mod.Trainer._maybe_unfreeze = unfreeze
        trainer_mod.Trainer.train = train_loop
    return restore


def _run_trainer(mt, snaps, at_end=None) -> dict:
    """ModelTrainer.train with the launch counts set to 0 just before and
    read just after; parameters snapshot at the start, the unfreeze and the
    end of the loop."""
    from ts_asr_whisper_tpu_torch import kernels

    phase_labels, loop_s = {}, []
    restore = _watch_trainer(snaps, phase_labels, loop_s, at_end)
    for name in kernels.launch_counts:
        kernels.launch_counts[name] = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        mt.train()
    finally:
        restore()
    torch.cuda.synchronize()
    return {"launches": dict(kernels.launch_counts),
            "wall": time.perf_counter() - t0, "loop": loop_s[0],
            "peak": torch.cuda.max_memory_allocated() / 2**30,
            "labels": phase_labels}


def check_flash_site(tag: str, q, k, v, seed: int) -> dict:
    """The flash forward and backward on one call site's own q, k, v (as
    the main path gave them; extra leading dims flatten into the batch, as
    ``sdpa`` does) against their plain versions: the forward's out and lse
    within TOLS / LSE_TOL (phase 3), the backward, both fed the kernel
    forward's (out, lse) as in phase 3b, within BWD_F32_TOL (fp32) or
    BWD_BF16_REL (bf16). Raises if they disagree; returns the errors."""
    from ts_asr_whisper_tpu_torch.ops import attention as A

    q, k, v = (x.reshape(-1, *x.shape[-3:]) for x in (q, k, v))
    dt = q.dtype
    with torch.no_grad():
        out, lse = A.flash_mha_fwd(q, k, v, with_lse=True)
        ref, ref_lse = A.flash_mha_reference(q, k, v, with_lse=True)
        g = torch.randn(out.shape, device=q.device, generator=torch.Generator(
            device=q.device).manual_seed(seed)).to(dt)
        got = A.flash_mha_bwd(q, k, v, out, lse, g)
        want = A.flash_mha_bwd_reference(q, k, v, out, lse, g)
    torch.cuda.synchronize()
    atol, rtol = TOLS[dt]
    ok = (torch.allclose(out.float(), ref.float(), atol=atol, rtol=rtol)
          and torch.allclose(lse, ref_lse, atol=LSE_TOL, rtol=LSE_TOL))
    res = {"fwd_max_abs_err": (out.float() - ref.float()).abs().max().item(),
           "lse_max_abs_err": (lse - ref_lse).abs().max().item()}
    errs, rels = [], []
    for a, r in zip(got, want):
        a, r = a.float(), r.float()
        errs.append((a - r).abs().max().item())
        rels.append(((a - r).norm() / r.norm()).item())
        ok = ok and (torch.allclose(a, r, atol=BWD_F32_TOL, rtol=BWD_F32_TOL)
                     if dt == torch.float32 else rels[-1] <= BWD_BF16_REL)
    res.update(bwd_max_abs_err=max(errs), bwd_frobenius_rel=max(rels))
    bwd_tol = (f"atol/rtol {BWD_F32_TOL}" if dt == torch.float32
               else f"Frobenius rel <= {BWD_BF16_REL}")
    log(f"{tag} at {tuple(q.shape)} {str(dt)[6:]}: forward max_abs_err "
        f"{res['fwd_max_abs_err']:.3e} (atol {atol}, rtol {rtol}), lse "
        f"{res['lse_max_abs_err']:.3e} (atol/rtol {LSE_TOL}); backward "
        f"dq/dk/dv max_abs_err {', '.join(f'{e:.3e}' for e in errs)}, "
        f"Frobenius rel {', '.join(f'{r:.3e}' for r in rels)} ({bwd_tol})")
    if not ok:
        raise AssertionError(f"{tag}: the flash kernels disagree with their "
                             "plain versions")
    return res


def phase_se_dicow_train(dev) -> dict:
    """+train=se_dicow through ModelTrainer at turbo width: 8 SCBs,
    self-enrollment (each row's enrollment is the 30 s of its own recording
    where its speaker talks most), every SCB gate opened before the run so
    that the SCB cross-attention's dk / dv carry a signal into the
    enrollment stream; 2 preheat micro-batches, then 2 base ones, in
    updates of 2. The flash forward and backward against their plain
    versions on the run's own inputs of two call sites: the first SCB's
    cross-attention and the first encoder layer's self-attention over both
    streams (B * 2 rows). The export decodes through the port's SE-DiCoW
    greedy path."""
    from ts_asr_whisper_tpu_torch.config import load_config
    from ts_asr_whisper_tpu_torch.data.synthetic import write_corpus
    from ts_asr_whisper_tpu_torch.decode import DecodeRunner
    from ts_asr_whisper_tpu_torch.ops import attention as A
    from ts_asr_whisper_tpu_torch.train import ModelTrainer

    gc.collect()
    torch.cuda.empty_cache()
    work = WORK / "se_dicow_train"
    shutil.rmtree(work, ignore_errors=True)
    manifest = write_corpus(work / "corpus", [30.0] * 4, seed=2)
    model_dir = _turbo_dir(work)
    out_dir = work / "exp"
    cfg = load_config([
        "+train=se_dicow", f"model.whisper_model={model_dir}",
        f"model.scb_layers={SCB_LAYERS}", "model.reinit_encoder_from=null",
        f"data.train_cutsets=[{manifest}]", "data.dev_cutsets=[]",
        "data.eval_cutsets=[]", "data.enrollment_cutsets=[]",
        "data.dataset_weights=null", "aug.musan_root=null",
        "training.overall_batch_size=8",
        "training.gradient_accumulation_steps=2", "training.max_steps=4",
        "training.use_fddt_only_n_steps=2", "training.warmup_steps=0",
        "training.eval_strategy=no", "training.save_strategy=no",
        "training.logging_steps=1", f"training.output_dir={out_dir}"])
    t = cfg.training
    t0 = time.perf_counter()
    mt = ModelTrainer(cfg, dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    model, mc = mt.model, mt.container.model_config
    enc = model.encoder
    with torch.no_grad():  # a fresh gate is 0: tanh(0) stops every signal
        for i, scb in enumerate(enc.ca_enrolls):
            scb.cae.cross_gate.gate.fill_(0.3 + 0.05 * i)
    per_batch = mc.encoder_layers + mc.scb_layers + int(
        mc.ctc_weight > 0 and (mc.additional_layer
                               or mc.additional_self_attention_layer))
    log(f"[se_dicow_train] {len(mt.train_dataset)} rows with "
        f"self-enrollment, micro-batch {t.per_device_train_batch_size}, "
        f"accumulation {t.gradient_accumulation_steps}, {t.max_steps} "
        f"micro-batches ({t.use_fddt_only_n_steps} preheat), "
        f"{mc.scb_layers} SCBs (gates opened), {per_batch} flash calls per "
        f"micro-batch; set-up {setup_s:.1f} s")
    # inputs of the first micro-batch: the first SCB's cross-attention
    # (x_q from the sample stream, x_kv from the enrollment stream) and the
    # first encoder layer (both streams)
    scb_in, layer_in = [], []
    hooks = [enc.ca_enrolls[0].cae.cross_attn.register_forward_hook(
        lambda mod, args, out: scb_in.append(
            tuple(a.detach() for a in args[:2])) if not scb_in else None),
        enc.layers[0].register_forward_hook(
            lambda mod, args, out: layer_in.append(args[0].detach())
            if not layer_in else None)]
    snaps = {"start": _snapshot(model)}
    try:
        res = _run_trainer(mt, snaps)
    finally:
        for hook in hooks:
            hook.remove()
    snaps["end"] = _snapshot(model)
    launches = res["launches"]
    updates = t.max_steps // t.gradient_accumulation_steps
    recs = [json.loads(line) for line in
            (out_dir / "metrics.jsonl").read_text().splitlines()]
    log(f"[se_dicow_train] {t.max_steps} micro-batches, {updates} updates: "
        f"training loop {res['loop']:.2f} s, "
        f"{res['loop'] * 1e3 / updates:.0f} ms per optimizer update "
        f"(warm-up and data loading included); ModelTrainer.train "
        f"{res['wall']:.1f} s with the HF export; peak mem "
        f"{res['peak']:.1f} GiB; launches {launches}; losses "
        f"{[round(r['loss'], 4) for r in recs]}")
    if len(recs) != t.max_steps or not all(
            math.isfinite(r[k]) for r in recs
            for k in ("loss", "dec_loss", "ctc_loss", "grad_norm")):
        raise AssertionError(f"se_dicow_train: steps not all finite: {recs}")
    want = per_batch * t.max_steps
    if not launches["flash_attn_fwd"] == launches["flash_attn_bwd"] == want:
        raise AssertionError(f"se_dicow_train: flash launches {launches}, "
                             f"want {want} forward and backward")
    labels = res["labels"]
    pre = {n for n, lab in labels["preheat"].items() if lab == "preheat"}
    changed = _changed(snaps["start"], snaps["preheat"])
    scb_kv = {n for n in pre if ".ca_enrolls." in n
              and (".k_proj." in n or ".v_proj." in n)}
    if not changed <= pre or not scb_kv or not scb_kv <= changed:
        raise AssertionError(
            f"se_dicow_train preheat changed {len(changed)} tensors, "
            f"{sorted(changed - pre)[:5]} outside the preheat group, SCB "
            f"k/v projections unchanged: {sorted(scb_kv - changed)[:5]}")
    changed_base = _changed(snaps["preheat"], snaps["end"])
    if any(".decoder." in n for n in changed_base):
        raise AssertionError("se_dicow_train: the base phase moved the "
                             "decoder")
    log(f"[se_dicow_train] preheat changed {len(changed)} of {len(pre)} "
        f"preheat tensors (the {len(scb_kv)} SCB k/v projections among "
        f"them: dk / dv reached the enrollment stream) and nothing else; "
        f"base changed {len(changed_base)}, decoder bit-identical")

    # the flash kernels against their plain versions at two call sites of
    # the run, on their own inputs
    x_q, x_kv = scb_in[0]
    if torch.equal(x_q, x_kv) or layer_in[0].shape[1] != 2:
        raise AssertionError("se_dicow_train: the SCB's streams are equal or "
                             "layer 0 ran on one stream")
    attn = enc.ca_enrolls[0].cae.cross_attn
    dt = mc.compute_dtype
    with torch.no_grad():
        q = attn.query(x_q, dt)
        k, v = attn.keys_values(x_kv, dt)
    site = {"scb0": check_flash_site(
        "[se_dicow_train] SCB 0 cross-attention (q from the sample stream, "
        "k/v from the enrollment stream)", q, k, v, seed=3)}
    with torch.no_grad():
        q, k, v = enc.layers[0].attn_in(layer_in[0], dt)
    site["layer0"] = check_flash_site(
        "[se_dicow_train] encoder layer 0 self-attention on both streams",
        q, k, v, seed=4)
    del mt, model, enc, attn, q, k, v, scb_in, layer_in, snaps
    gc.collect()
    torch.cuda.empty_cache()

    # the export decodes through SE-DiCoW greedy (self-enrollment)
    export = out_dir / "hf_export"
    dcfg = load_config([
        "+decode=se_dicow_greedy", f"model.whisper_model={export}",
        f"model.scb_layers={SCB_LAYERS}", "model.use_enrollments=true",
        "data.use_enrollments=true", "data.enrollment_cutsets=[]",
        "model.ctc_weight=0.3", f"data.eval_cutsets=[{manifest}]",
        "training.generation_max_length=32",
        "training.per_device_eval_batch_size=8",
        "training.save_visualizations=false",
        f"training.output_dir={work / 'decode'}"])
    runner = DecodeRunner(dcfg, dev)
    gates = [round(s.cae.cross_gate.gate.item(), 4)
             for s in runner.container.model.encoder.ca_enrolls]
    metrics = runner.run()
    tcp = metrics.get("eval_eval_cutset_tcp_wer")
    log(f"[se_dicow_train] hf_export decoded by se_dicow_greedy: SCB gates "
        f"{gates}, tcp_wer {tcp}, {runner.windows_decoded} row-windows")
    if tcp is None or not math.isfinite(tcp) or not any(gates):
        raise AssertionError(f"se_dicow_train: export decode {metrics}, "
                             f"gates {gates}")
    del runner
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "ms_per_update": res["loop"] * 1e3 / updates,
            "peak_gib": res["peak"], "flash_sites": site}


def phase_pretrain(dev) -> dict:
    """+pretrain=turbo through the pre-training entry point: the encoder
    without FDDTs frozen, the CTC head's bare self-attention (flash forward
    and backward) trained for a few steps at micro-batch 8, then a dev
    evaluation of 60 s recordings cut into 30 s pieces and decoded by
    greedy CTC. Only the PRETRAIN_TRAINABLE modules change. The head's
    flash forward and backward against their plain versions on the first
    step's own inputs."""
    from safetensors.torch import load_file

    from ts_asr_whisper_tpu_torch import kernels
    from ts_asr_whisper_tpu_torch import pretrain_encoder as P
    from ts_asr_whisper_tpu_torch.config import load_config
    from ts_asr_whisper_tpu_torch.data.synthetic import write_corpus
    from ts_asr_whisper_tpu_torch.models.containers import WhisperContainer
    from ts_asr_whisper_tpu_torch.models.convert import normalize_state_dict
    from ts_asr_whisper_tpu_torch.training.optim import path_matches

    gc.collect()
    torch.cuda.empty_cache()
    work = WORK / "pretrain"
    shutil.rmtree(work, ignore_errors=True)
    train = write_corpus(work / "train", [30.0] * 4, seed=3)
    devset = write_corpus(work / "dev", [60.0] * 2, seed=4)
    model_dir = _turbo_dir(work)
    out_dir = work / "exp"
    overrides = [
        "+pretrain=turbo", f"model.whisper_model={model_dir}",
        f"data.train_cutsets=[{train}]", f"data.dev_cutsets=[{devset}]",
        "data.dataset_weights=null", "training.max_steps=4",
        "training.per_device_train_batch_size=8",
        "training.per_device_eval_batch_size=4", "training.logging_steps=1",
        "training.save_strategy=no", f"training.output_dir={out_dir}"]
    cfg = load_config(overrides)
    step_t, dev_frames, head_in = [], [], []
    loss_fn, decode = P.pretrain_loss, P.ctc_decode_chunked

    def timed_loss(*args):
        torch.cuda.synchronize()
        step_t.append(time.perf_counter())
        if len(step_t) > 1:
            return loss_fn(*args)
        # the first step: the CTC head's self-attention inputs, kept for
        # the check against the plain versions
        head = args[0].encoder.additional_self_attention_layer
        hook = head.register_forward_hook(lambda mod, a, out: head_in.append(
            (mod, a[0].detach(), a[1].detach(), a[2])))
        try:
            return loss_fn(*args)
        finally:
            hook.remove()

    def seen_decode(model, mc, feats):
        dev_frames.append(feats.shape[-1])
        return decode(model, mc, feats)

    P.pretrain_loss, P.ctc_decode_chunked = timed_loss, seen_decode
    for name in kernels.launch_counts:
        kernels.launch_counts[name] = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        metrics = P.main(cfg, dev)
    finally:
        P.pretrain_loss, P.ctc_decode_chunked = loss_fn, decode
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    peak = torch.cuda.max_memory_allocated() / 2**30
    t = cfg.training
    steps = len(step_t)
    ms_step = sorted((b - a) * 1e3 for a, b in zip(step_t, step_t[1:]))
    ms_step = ms_step[len(ms_step) // 2]
    mc_layers = TURBO["encoder_layers"]
    windows = len(dev_frames) and sum(-(-f // 3000) for f in dev_frames)
    want_fwd = (mc_layers + 1) * (steps + len(dev_frames))
    log(f"[pretrain] {steps} steps at micro-batch "
        f"{t.per_device_train_batch_size}: median {ms_step:.0f} ms per step "
        f"(loss to loss, data loading included), main {wall:.1f} s with the "
        f"HF export and the dev eval; peak mem {peak:.1f} GiB; launches "
        f"{launches} (per step {mc_layers + 1} forward, 1 backward); dev "
        f"feature lengths {dev_frames} ({windows} x 30 s pieces); "
        f"metrics {metrics}")
    if steps != t.max_steps or not metrics or not all(
            math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"pretrain: {steps} steps, metrics {metrics}")
    if not dev_frames or min(dev_frames) <= 3000:
        raise AssertionError(f"pretrain: dev inputs {dev_frames} frames, "
                             "none over 30 s")
    if launches["flash_attn_bwd"] != steps or \
            launches["flash_attn_fwd"] != want_fwd:
        raise AssertionError(f"pretrain: launches {launches}, want "
                             f"{want_fwd} forward, {steps} backward")
    # only the CTC head moved: against the same seeded init
    start = dict(WhisperContainer(load_config(overrides), dev,
                                  seed=t.seed).model.state_dict())
    sd = normalize_state_dict(load_file(str(out_dir / "hf_export"
                                            / "model.safetensors")))
    moved = {k for k, v in sd.items()
             if not torch.equal(v.to(dev), start[k].to(v.dtype))}
    outside = {k for k in moved if not path_matches(
        k.removeprefix("model.").replace(".", "/"), P.PRETRAIN_TRAINABLE)}
    log(f"[pretrain] export: {len(moved)} of {len(sd)} tensors moved, all "
        f"under {P.PRETRAIN_TRAINABLE}: {not outside}")
    if not moved or outside:
        raise AssertionError(f"pretrain moved {sorted(outside)[:5]} outside "
                             "the CTC head")
    # the head's flash forward and backward against their plain versions,
    # on the first step's own inputs
    head, x_q, x_kv, dt = head_in[0]
    with torch.no_grad():
        q = head.query(x_q, dt)
        k, v = head.keys_values(x_kv, dt)
    site = check_flash_site("[pretrain] CTC head self-attention", q, k, v,
                            seed=5)
    del start, sd, head_in, head, x_q, x_kv, q, k, v
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "ms_per_step": ms_step, "peak_gib": peak,
            "flash_sites": {"head": site}}


def phase_remat(dev) -> dict:
    """2 micro-batches of 4 of the dicow_v3 fine-tune (base phase: decoder
    frozen) without gradient checkpointing and with the remat policies
    'full', 'dots' and 'attn', from the same weights and batches: the same
    losses, gradients within the bf16 dq tolerance, one flash forward per
    layer fewer under 'attn' than 'full'; the flash forward and backward
    against their plain versions on layer 0's own inputs (the shapes of
    every dicow_v3 training path). Each is warmed up by a micro-batch
    of its own; the launch counts are set to 0 before its timed run and read
    after it."""
    from ts_asr_whisper_tpu_torch import kernels
    from ts_asr_whisper_tpu_torch.config import load_config
    from ts_asr_whisper_tpu_torch.data.synthetic import write_corpus
    from ts_asr_whisper_tpu_torch.train import ModelTrainer
    from ts_asr_whisper_tpu_torch.training.dataloader import DataLoader
    from ts_asr_whisper_tpu_torch.training.optim import param_labels
    from ts_asr_whisper_tpu_torch.training.trainer import loss_fn, to_device

    gc.collect()
    torch.cuda.empty_cache()
    work = WORK / "remat"
    shutil.rmtree(work, ignore_errors=True)
    manifest = write_corpus(work / "corpus", [30.0] * 4, seed=5)
    cfg = load_config([
        "+train=dicow_v3", f"model.whisper_model={_turbo_dir(work)}",
        "model.reinit_encoder_from=null", f"data.train_cutsets=[{manifest}]",
        "data.dev_cutsets=[]", "data.eval_cutsets=[]",
        "data.dataset_weights=null", "aug.musan_root=null",
        "training.gradient_checkpointing=true",
        f"training.output_dir={work / 'exp'}"])
    mt = ModelTrainer(cfg, dev)
    model, mc = mt.model, mt.container.model_config
    labels = param_labels(model, cfg.model.prefixes_to_preheat,
                          cfg.model.params_to_keep_frozen_keywords, False)
    for name, p in model.named_parameters():
        p.requires_grad_(labels[name] != "frozen")
    model.train()
    loader = iter(DataLoader(mt.train_dataset, mt.collator, batch_size=4,
                             seed=0, num_workers=0))
    batches = [to_device(next(loader), dev) for _ in range(3)]
    num_prefix = len(mt.container.tokenizer.prefix_tokens) - 1
    trainable = [p for p in model.parameters() if p.requires_grad]

    def run(policy, micro):
        model.set_gradient_checkpointing(policy is not None, policy or "full")
        for p in trainable:
            p.grad = None
        losses = []
        for b in micro:
            total, _ = loss_fn(model, mc, b, num_prefix)
            total.backward()
            losses.append(total.detach())
        return losses

    out, ref = {}, None
    # layer 0's input of the first micro-batch, for the check of the flash
    # kernels on this path's own inputs (kept on the host: the peaks stay
    # comparable)
    layer_in = []
    hook = model.encoder.layers[0].register_forward_hook(
        lambda mod, args, o: layer_in.append(args[0].detach().cpu())
        if not layer_in else None)
    # two rounds, the second in reverse order: host-bound times drift
    order = (None, "full", "dots", "attn")
    for policy in order + order[::-1]:
        # a micro-batch of this policy first: allocator growth and cuBLAS
        # handles stay out of the timed ones
        run(policy, batches[2:])
        for name in kernels.launch_counts:
            kernels.launch_counts[name] = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses = run(policy, batches[:2])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / 2
        key = policy or "off"
        if key in out:  # the second round adds its time
            out[key]["ms_rounds"].append(ms)
            continue
        r = {"ms_rounds": [ms], "launches": dict(kernels.launch_counts),
             "peak": torch.cuda.max_memory_allocated() / 2**30,
             "losses": [float(x) for x in losses]}
        if ref is None:  # kept on the host: the peaks stay comparable
            ref = [p.grad.detach().to("cpu", copy=True) for p in trainable]
        num = sum((p.grad.float() - f.to(dev).float()).square().sum()
                  for p, f in zip(trainable, ref))
        den = sum(f.to(dev).float().square().sum() for f in ref)
        r["grad_rel"] = float((num / den).sqrt())
        r["device_ms"] = measure_device_ms(lambda: run(policy, batches[:1]),
                                           reps=2)
        out[key] = r
    hook.remove()
    with torch.no_grad():
        q, k, v = model.encoder.layers[0].attn_in(layer_in[0].to(dev),
                                                  mc.compute_dtype)
    check_flash_site("[remat] encoder layer 0 self-attention", q, k, v,
                     seed=6)
    del q, k, v, layer_in
    for key, r in out.items():
        r["ms"] = min(r["ms_rounds"])
        log(f"[remat] {key}: {' / '.join(f'{x:.0f}' for x in r['ms_rounds'])}"
            f" ms per micro-batch of 4 in the two rounds (forward + "
            f"backward; device {fmt_ms(r['device_ms'])}), peak mem "
            f"{r['peak']:.1f} GiB, losses {r['losses']}, gradients vs no "
            f"checkpointing Frobenius rel {r['grad_rel']:.3e}, launches "
            f"{r['launches']}")
    ref = out["off"]
    fwd = {p: r["launches"]["flash_attn_fwd"] for p, r in out.items()}
    layers = mc.encoder_layers
    if any(r["losses"] != ref["losses"] for r in out.values()):
        raise AssertionError("remat: the policies' losses differ")
    if any(r["grad_rel"] > BWD_BF16_REL for r in out.values()):
        raise AssertionError("remat: gradients differ beyond the bf16 dq "
                             "tolerance")
    if not (fwd["attn"] == fwd["off"] == fwd["full"] - 2 * layers and
            fwd["dots"] == fwd["full"]):
        raise AssertionError(f"remat: flash forwards {fwd}; 'attn' should "
                             f"skip one per layer ({layers} x 2)")
    del mt, model, batches, trainable, loader, ref
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_lora(dev) -> dict:
    """+train=dicow_v3 with training.use_lora=true through ModelTrainer at
    turbo width: 2 preheat micro-batches (adapters frozen), 4 base ones (B
    leaves 0 in the first base update, A moves from the second).
    Only the adapters and the non-decoder parameters move; the export has
    no adapter keys and equals the merge W + scale * B A."""
    from safetensors.torch import load_file

    from ts_asr_whisper_tpu_torch.config import load_config
    from ts_asr_whisper_tpu_torch.data.synthetic import write_corpus
    from ts_asr_whisper_tpu_torch.models.convert import normalize_state_dict
    from ts_asr_whisper_tpu_torch.train import ModelTrainer
    from ts_asr_whisper_tpu_torch.training.lora import lora_linears

    gc.collect()
    torch.cuda.empty_cache()
    work = WORK / "lora"
    shutil.rmtree(work, ignore_errors=True)
    manifest = write_corpus(work / "corpus", [30.0] * 4, seed=6)
    out_dir = work / "exp"
    cfg = load_config([
        "+train=dicow_v3", f"model.whisper_model={_turbo_dir(work)}",
        "model.reinit_encoder_from=null", f"data.train_cutsets=[{manifest}]",
        "data.dev_cutsets=[]", "data.eval_cutsets=[]",
        "data.dataset_weights=null", "aug.musan_root=null",
        "training.use_lora=true", "training.overall_batch_size=8",
        "training.gradient_accumulation_steps=2", "training.max_steps=6",
        "training.use_fddt_only_n_steps=2", "training.warmup_steps=0",
        "training.eval_strategy=no", "training.save_strategy=no",
        "training.logging_steps=1", f"training.output_dir={out_dir}"])
    mt = ModelTrainer(cfg, dev)
    model = mt.model
    snaps = {"start": _snapshot(model)}
    merged = {}

    def before_merge(trainer):
        snaps["end"] = _snapshot(trainer.model)
        with torch.no_grad():
            for name, m in lora_linears(trainer.model):
                merged[f"{name}.weight"] = (m.weight + (
                    m.lora_B @ m.lora_A) * m.lora_scale).cpu()

    res = _run_trainer(mt, snaps, at_end=before_merge)
    end = snaps["end"]
    adapters = {n for n in end if n.endswith(("lora_A", "lora_B"))}
    moved = {n for n in end if n in adapters
             or not torch.equal(end[n], snaps["start"][n])}
    moved_lora = {n for n in adapters
                  if not torch.equal(end[n], snaps["preheat"][n])}
    dense_dec = {n for n in moved - adapters if ".decoder." in n}
    updates = 3
    log(f"[lora] {len(adapters)} adapter tensors on "
        f"{len(merged)} decoder q/v projections; "
        f"{res['loop'] * 1e3 / updates:.0f} ms per optimizer update, peak "
        f"mem {res['peak']:.1f} GiB; base phase moved {len(moved_lora)} "
        f"adapter tensors, {len(moved - adapters)} base tensors "
        f"({len(dense_dec)} of the decoder); launches {res['launches']}")
    if moved_lora != adapters or dense_dec or not moved - adapters:
        raise AssertionError("lora: only the adapters and the non-decoder "
                             "parameters should move")
    del mt, model
    gc.collect()
    torch.cuda.empty_cache()
    sd = normalize_state_dict(load_file(str(out_dir / "hf_export"
                                            / "model.safetensors")))
    bad = [k for k in sd if "lora" in k]
    for k in set(end) - adapters:
        want = merged.get(k, end[k])
        if not torch.allclose(sd[k], want, atol=1e-6, rtol=0):
            bad.append(k)
    log(f"[lora] hf_export: {len(sd)} tensors, no adapter keys, "
        f"{len(merged)} merged weights equal W + scale * B A: {not bad}")
    if bad:
        raise AssertionError(f"lora export: {bad[:5]}")
    return {"launches": res["launches"],
            "ms_per_update": res["loop"] * 1e3 / updates,
            "peak_gib": res["peak"]}


def phase_int8_cross_kv(runner, dev) -> None:
    """Phase 18 (run on phase 7's runner): greedy decode of the phase-7
    corpus's first window at batch 16 over the exact and the int8
    cross-KV, run to full length (125 steps): ms per step (host clock, one
    call each way after a warm-up call), device ms per step
    (utils/devicetime.py, a further call), the cross-KV bytes and the peak
    memory of each. Numbers to record; int8 is lossy, so the tokens may
    differ."""
    import dataclasses

    from ts_asr_whisper_tpu_torch.decoding.greedy import greedy_decode
    from ts_asr_whisper_tpu_torch.models.whisper import quantize_cross_kv
    from ts_asr_whisper_tpu_torch.training.dataloader import eval_batches
    from ts_asr_whisper_tpu_torch.utils.device import force_execution

    steps = 125
    model = runner.container.model
    ds = runner.eval_datasets["eval_cutset"]
    _, batch = next(iter(eval_batches(ds, runner.collator, 16,
                                      pad_to_full=True)))
    feats = torch.as_tensor(batch["input_features"][:, :, :3000]).to(dev)
    stno = torch.as_tensor(batch["stno_mask"][:, :, :1500]).to(dev)
    prompt = torch.tensor(runner.container.tokenizer.prefix_tokens[:3],
                          device=dev).repeat(feats.shape[0], 1)
    with torch.no_grad():
        enc = model.encoder(feats, stno)
        cross = model.decoder.precompute_cross_kv(enc)
        nbytes = {"exact": sum(t.numel() * t.element_size()
                               for kv in cross for t in kv),
                  "int8": sum(t.numel() * t.element_size()
                              for kv in quantize_cross_kv(cross)
                              for t in kv.values())}
    del cross
    res = {}
    for mode in ("exact", "int8"):
        gen_cfg = dataclasses.replace(runner.gen_cfg,
                                      cross_kv_quant=mode == "int8")

        def run():
            return greedy_decode(model, gen_cfg, enc, prompt, steps,
                                 force_full_length=True)

        force_execution(run())  # warm-up
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = run()
        force_execution(out)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        dev_ms = measure_device_ms(run, reps=1, warmup=0)
        res[mode] = out.sequences
        log(f"[int8_cross_kv] {mode}: {wall * 1e3 / steps:.2f} ms/step, "
            f"device {fmt_ms(None if dev_ms is None else dev_ms / steps)} "
            f"per step, cross-KV {nbytes[mode] / 1e6:.1f} MB, peak "
            f"{peak:.2f} GiB (batch {feats.shape[0]}, {steps} steps)")
        if dev_ms is None:
            raise AssertionError("int8_cross_kv: the profiler caught no "
                                 "kernel")
    differ = (res["exact"] != res["int8"]).any(dim=1).sum().item()
    log(f"[int8_cross_kv] rows whose tokens differ: {differ} of "
        f"{feats.shape[0]}")
    del model, enc, res


def phase_fallback_int8(dev) -> dict:
    """Phase 16: dicow_v3_beam_joint through the decode entry point over
    the int8 cross-KV (decoding.cross_kv_quant=true), the model dir's
    generation_config.json holding FALLBACK_GEN, 1 recording of 60 s (2
    rows, batch 2). Counts the fallback retries (greedy, sampled) per
    window; the ancestry kernel in every decoder layer of every beam step,
    the psi kernel once per beam step and never in a retry (its count
    equals the beam steps); the same run again gives the same hypotheses
    (seeded generators); layer 0's cross-attention on its own inputs of the
    run's first window, int8 against exact cross-KV in fp32, within
    tests/test_kv_quant.py's bound."""
    from ts_asr_whisper_tpu_torch.decoding import longform
    from ts_asr_whisper_tpu_torch.models.whisper import quantize_cross_kv

    tag = "beam_joint_fallback_int8"
    greedy_decode, beam_search = longform.greedy_decode, longform.beam_search
    retries, windows, first = [], [0], {}

    def counted_greedy(*args, **kwargs):
        retries.append(kwargs.get("temperature", 0.0))
        return greedy_decode(*args, **kwargs)

    def captured_beam(model, gen_cfg, enc, init_tokens, *args, **kwargs):
        windows[0] += 1
        first.setdefault("enc", enc)
        first.setdefault("prompt", init_tokens)
        return beam_search(model, gen_cfg, enc, init_tokens, *args, **kwargs)

    longform.greedy_decode = counted_greedy
    longform.beam_search = captured_beam
    try:
        res = run_beam_decode(dev, tag, ["+decode=dicow_v3_beam_joint",
                                         "model.ctc_weight=0.3",
                                         "decoding.cross_kv_quant=true"],
                              [60.0], gen_json=FALLBACK_GEN)
    finally:
        longform.greedy_decode = greedy_decode
        longform.beam_search = beam_search
    steps, launches, runner = res["steps"], res["launches"], res["runner"]
    gen_cfg = runner.gen_cfg
    layers = TURBO["decoder_layers"]
    by_temp = {t: retries.count(t) for t in sorted(set(retries))}
    log(f"[{tag}] {windows[0]} beam window batches, greedy retries by "
        f"temperature {by_temp}: "
        f"{len(retries) / max(windows[0], 1):.2f} per window batch; "
        f"launches {launches}")
    if not gen_cfg.cross_kv_quant or tuple(gen_cfg.temperature) != tuple(
            FALLBACK_GEN["temperature"]):
        raise AssertionError(f"{tag}: not an int8 fallback decode: "
                             f"{gen_cfg}")
    if set(by_temp) != {0.4, 0.8}:
        raise AssertionError(f"{tag}: retries {by_temp}, want both "
                             "temperatures of the ladder")
    if launches["ancestry_attn"] != layers * steps:
        raise AssertionError(f"{tag}: ancestry_attn launched "
                             f"{launches['ancestry_attn']} times, want "
                             f"{layers * steps}")
    if launches["kv_reorder_bhtd"] or launches["kv_reorder_tbhd"]:
        raise AssertionError(f"{tag}: a reorder kernel ran: {launches}")

    hyps = [p.read_text() for p in res["hyps"]]
    runner.run()
    again = [p.read_text() for p in res["hyps"]]
    if again != hyps:
        raise AssertionError(f"{tag}: a second run gave other hypotheses")
    log(f"[{tag}] a second run gave the same {len(hyps)} hypothesis files")

    # layer 0's cross-attention on its own inputs of the run's first window:
    # its query in the prompt's prefill, the run's exact cross-KV, in fp32
    # so that only the int8 rounding differs
    from ts_asr_whisper_tpu_torch.models import whisper as W

    dec = runner.container.model.decoder
    enc, prompt = first["enc"], first["prompt"]
    cross_attention, queries = W.cross_attention, []

    def captured_cross(q, cross, dtype):
        queries.append(q)
        return cross_attention(q, cross, dtype)

    W.cross_attention = captured_cross
    try:
        with torch.no_grad():
            cross = dec.precompute_cross_kv(enc)
            b, p = prompt.shape
            dec.decoder_cached(prompt, 0, dec.init_kv_cache(b, p, dev), cross)
    finally:
        W.cross_attention = cross_attention
    q0, (k0, v0) = queries[0].float(), cross[0]
    with torch.no_grad():
        h_exact = cross_attention(q0, (k0.float(), v0.float()),
                                  torch.float32)
        h_int8 = cross_attention(q0, quantize_cross_kv([(k0, v0)])[0],
                                 torch.float32)
    err = (h_exact - h_int8).abs().max().item()
    lim = KV_QUANT_REL * h_exact.std().item()
    log(f"[{tag}] layer 0's cross-attention on the run's first window, fp32,"
        f" int8 vs exact cross-KV: max |dh| {err:.4e} (bound {lim:.4e} = "
        f"{KV_QUANT_REL} std(h)), q {tuple(q0.shape)}, k/v "
        f"{tuple(k0.shape)} {k0.dtype}")
    if not 0 < err < lim:
        raise AssertionError(f"{tag}: int8 cross-attention off by {err}")
    del runner, dec, enc, cross, first, queries
    return res


def phase_token_ts(dev) -> dict:
    """Phase 17: long-form greedy (dicow_v3_greedy settings) with token
    timestamps through ``longform_generate`` on 2 recordings of 60 s (4
    rows, batch 4), alignment heads TS_HEADS, the DTW cropped to each
    recording's frames: every segment carries per-token times; within each
    window they are non-decreasing and inside the window; the flash kernel
    in every encoder layer. Then ms per greedy step at batch 4 with and
    without the alignment collection, in turns."""
    import dataclasses

    import numpy as np

    from ts_asr_whisper_tpu_torch import kernels
    from ts_asr_whisper_tpu_torch.config import load_config
    from ts_asr_whisper_tpu_torch.data.synthetic import write_corpus
    from ts_asr_whisper_tpu_torch.decode import DecodeRunner
    from ts_asr_whisper_tpu_torch.decoding import longform
    from ts_asr_whisper_tpu_torch.decoding.greedy import greedy_decode
    from ts_asr_whisper_tpu_torch.decoding.token_timestamps import \
        alignment_slots_from_heads
    from ts_asr_whisper_tpu_torch.models.dicow import DiCoWEncoder
    from ts_asr_whisper_tpu_torch.training.dataloader import eval_batches
    from ts_asr_whisper_tpu_torch.utils.device import force_execution

    tag = "greedy_token_ts"
    gc.collect()
    torch.cuda.empty_cache()
    work = WORK / tag
    shutil.rmtree(work, ignore_errors=True)
    manifest = write_corpus(work / "corpus", [60.0] * 2, seed=1)
    model_dir = work / "model"
    model_dir.mkdir(parents=True)
    (model_dir / "config.json").write_text(json.dumps(TURBO))
    cfg = load_config(["+decode=dicow_v3_greedy",
                       f"model.whisper_model={model_dir}",
                       f"data.eval_cutsets=[{manifest}]",
                       "training.generation_max_length=128",
                       "training.per_device_eval_batch_size=4",
                       "training.save_visualizations=false",
                       f"training.output_dir={work / 'exp'}"])
    runner = DecodeRunner(cfg, dev)
    model, tok = runner.container.model, runner.container.tokenizer
    gen_cfg = dataclasses.replace(runner.gen_cfg,
                                  return_token_timestamps=True,
                                  alignment_heads=TS_HEADS)
    batches = [b for _, b in eval_batches(runner.eval_datasets["eval_cutset"],
                                          runner.collator, 4,
                                          pad_to_full=True)]
    windows, calls = [], {"encoder": 0}
    retrieve = longform.retrieve_segment

    def recorded_retrieve(seq, ts_begin, nframes, offset,
                          token_timestamps=None, prompt_len=0):
        windows.append((nframes, offset, token_timestamps))
        return retrieve(seq, ts_begin, nframes, offset, token_timestamps,
                        prompt_len)

    def count_encoder(module, args, output):
        if isinstance(module, DiCoWEncoder):
            calls["encoder"] += 1

    longform.retrieve_segment = recorded_retrieve
    hook = torch.nn.modules.module.register_module_forward_hook(count_encoder)
    for name in kernels.launch_counts:
        kernels.launch_counts[name] = 0
    segments = []
    t0 = time.perf_counter()
    try:
        for batch in batches:
            forced = batch.get("forced_decoder_ids")
            detect = forced is None and bool(gen_cfg.lang_ids)
            if forced is None:
                forced = np.tile(np.asarray(tok.prefix_tokens[:3]),
                                 (batch["input_features"].shape[0], 1))
            out = longform.longform_generate(
                model, gen_cfg, batch["input_features"], batch["stno_mask"],
                batch["attention_mask"], forced, return_segments=True,
                detect_lang=detect,
                token_ts_num_frames=batch["attention_mask"].sum(-1))
            segments.extend(s for row in out.segments for s in row)
    finally:
        longform.retrieve_segment = retrieve
        hook.remove()
    force_execution(list(model.parameters())[:1])
    wall = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    n_tok = sum(len(s.tokens) for s in segments)
    log(f"[{tag}] {len(batches)} batch(es) of 4 rows, {len(windows)} "
        f"row-windows, {len(segments)} segments, {n_tok} tokens, "
        f"{calls['encoder']} encoder calls, wall {wall:.1f} s, launches "
        f"{launches}, alignment heads {TS_HEADS}")
    if not segments or any(s.token_timestamps is None
                           or not np.isfinite(s.token_timestamps).all()
                           for s in segments):
        raise AssertionError(f"{tag}: a segment without token timestamps")
    for nframes, offset, row in windows:
        if row is None or (np.diff(row) < 0).any() or row.min() < 0 \
                or row.max() > nframes * 0.01 + 1e-6:
            raise AssertionError(
                f"{tag}: window at {offset} s ({nframes} frames): token "
                f"times {None if row is None else row.tolist()}")
    want = TURBO["encoder_layers"] * calls["encoder"]
    if calls["encoder"] == 0 or launches["flash_attn_fwd"] != want:
        raise AssertionError(f"{tag}: flash_attn_fwd launched "
                             f"{launches['flash_attn_fwd']} times, want "
                             f"{want}")
    if any(launches[k] for k in ("ancestry_attn", "psi_gather_dot",
                                 "kv_reorder_bhtd", "kv_reorder_tbhd")):
        raise AssertionError(f"{tag}: beam kernels ran: {launches}")

    # ms per greedy step, with and without the alignment collection
    steps = 125
    gen = torch.Generator(device=dev).manual_seed(4)
    enc = torch.randn(4, 1500, TURBO["d_model"], device=dev, generator=gen) \
        .to(runner.container.model_config.compute_dtype)
    prompt = torch.tensor(tok.prefix_tokens[:3], device=dev).repeat(4, 1)
    slots = torch.as_tensor(alignment_slots_from_heads(
        TS_HEADS, TURBO["decoder_layers"], TURBO["decoder_attention_heads"]),
        device=dev)
    times = {"plain": [], "alignment": []}
    for rnd in range(2):
        for mode in (("plain", "alignment") if rnd == 0
                     else ("alignment", "plain")):
            kw = {"alignment_slots": slots} if mode == "alignment" else {}
            force_execution(list(model.parameters())[:1])
            t0 = time.perf_counter()
            force_execution(greedy_decode(model, gen_cfg, enc, prompt, steps,
                                          force_full_length=True, **kw))
            times[mode].append((time.perf_counter() - t0) * 1e3 / steps)
    per_mode = ", ".join(f"{m} {t[0]:.2f} / {t[1]:.2f} ms/step"
                         for m, t in times.items())
    log(f"[{tag}] greedy loop alone, batch 4, {steps} steps, in turns: "
        f"{per_mode}")
    del runner, model, enc
    return {"launches": launches}


def phase_mel_topk(dev) -> None:
    """Phase 19: the device log-mel (ops/mel.py) against the host
    featurizer at fp32 over 16 windows of 30 s at 128 mels (turbo),
    within tests/test_mel.py's tolerance; ms per 30 s window of each.
    Then the beam step's candidate top-k (rows of 5 x 51866 scores, batch
    2, top 10): the thresholded impl against the stable sort, equal and
    timed."""
    import numpy as np

    from ts_asr_whisper_tpu_torch.data.features import (N_SAMPLES,
                                                        log_mel_numpy)
    from ts_asr_whisper_tpu_torch.ops.mel import log_mel_spectrogram
    from ts_asr_whisper_tpu_torch.ops.topk import topk_lax, topk_thresholded
    from ts_asr_whisper_tpu_torch.utils.device import force_execution

    n_win = 16
    rng = np.random.default_rng(3)
    t = np.arange(N_SAMPLES) / 16000.0
    wav = (0.1 * np.sin(2 * np.pi * 220 * t)[None]
           + 0.02 * rng.standard_normal((n_win, N_SAMPLES))).astype(
               np.float32)
    host_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        ref = log_mel_numpy(wav, 128)
        host_ms.append((time.perf_counter() - t0) * 1e3 / n_win)
    x = torch.from_numpy(wav).to(dev)
    out = log_mel_spectrogram(x, 128)
    force_execution(out)
    diff = (out.cpu() - torch.from_numpy(ref)).abs()
    err = diff.max().item()
    bad = (diff > MEL_ATOL + MEL_RTOL * torch.from_numpy(ref).abs()).sum()
    dev_ms = median_ms(lambda: log_mel_spectrogram(x, 128), reps=10) / n_win
    dev_busy = measure_device_ms(lambda: log_mel_spectrogram(x, 128))
    busy = None if dev_busy is None else dev_busy / n_win
    log(f"[mel] device log-mel, 128 mels, {n_win} windows of 30 s: "
        f"max_abs_err vs the host featurizer {err:.3e} (atol {MEL_ATOL}, "
        f"rtol {MEL_RTOL}); ms per 30 s window: device {dev_ms:.4f} "
        f"(device busy {fmt_ms(busy)}), host featurizer {sorted(host_ms)[1]:.2f} "
        f"(runs {', '.join(f'{m:.2f}' for m in host_ms)})")
    if out.shape != (n_win, 128, 3000) or bad:
        raise AssertionError(f"mel: {int(bad)} values outside the tolerance")

    gen = torch.Generator(device=dev).manual_seed(5)
    scores = torch.randn(AUDIO_ROWS, BEAMS * TURBO["vocab_size"], device=dev,
                         generator=gen)
    # beams 1..4 of a first step: equal -1e9 rows
    scores[:, TURBO["vocab_size"]:] = -1e9
    k = 2 * BEAMS
    v_ref, i_ref = topk_lax(scores, k)
    v, i = topk_thresholded(scores, k)
    if not (torch.equal(v, v_ref) and torch.equal(i, i_ref)):
        raise AssertionError("topk: thresholded differs from the stable sort")
    res = {}
    for name, fn in (("stable sort", topk_lax),
                     ("thresholded", topk_thresholded)):
        res[name] = (median_ms(lambda: fn(scores, k), reps=20),
                     measure_device_ms(lambda: fn(scores, k)))
    log(f"[topk] beam step's candidate top-{k} over ({AUDIO_ROWS}, "
        f"{BEAMS} x {TURBO['vocab_size']}) fp32: "
        + ", ".join(f"{n} {ms:.4f} ms per call (device {fmt_ms(d)})"
                    for n, (ms, d) in res.items()))


# -- phases 20-26 and 28: data and tensor parallelism through the CLI under
# torchrun


def _checksums(tensors) -> list:
    """Two checksums a tensor: the sum of its fp32 bit patterns and the sum
    of them weighted by position."""
    sums = []
    with torch.no_grad():
        for t in tensors:
            bits = t.detach().float().reshape(-1).view(torch.int32) \
                .to(torch.int64)
            pos = torch.arange(1, bits.numel() + 1, device=bits.device)
            sums += [bits.sum(), (bits * pos).sum()]
    return torch.stack(sums).tolist()


def _record_trainer(record: dict):
    """Patch the Trainer to record what every rank logs, a digest of each
    batch's features and STNO masks, its loop's wall time and peak memory,
    the bytes of the gradients it all-reduces per micro-batch in each phase,
    the FSDP2 all-gather and reduce-scatter bytes and calls of the loop,
    each memory probe of auto_find_batch_size (micro-batch, outcome, kernel
    launches, ms, memory at its start and its peak) and, at the end, the
    micro-batch and accumulation it trained at, a checksum of every
    trainable parameter (``_checksums``: this rank's shard under FSDP2 or
    tensor parallelism) and which of them are TP slices, and under FSDP2
    the checksums of the gathered whole state, and the memory allocated
    when ``ModelTrainer._fit`` starts and after each rebuild of its model;
    returns the function that restores it."""
    import hashlib

    import torch.distributed as tdist

    from torch.distributed.fsdp import FSDPModule

    from ts_asr_whisper_tpu_torch import kernels
    from ts_asr_whisper_tpu_torch import train as train_mod
    from ts_asr_whisper_tpu_torch.parallel import tensor as tp_mod
    from ts_asr_whisper_tpu_torch.parallel.mesh import (_fsdp_param_groups,
                                                        full_state_dict,
                                                        is_sharded, local)
    from ts_asr_whisper_tpu_torch.parallel.tensor import model_group, tp_dim
    from ts_asr_whisper_tpu_torch.training import trainer as trainer_mod

    loop = trainer_mod.Trainer.train
    unfreeze = trainer_mod.Trainer._maybe_unfreeze
    probe = trainer_mod.Trainer.probe_step
    fit = train_mod.ModelTrainer._fit
    rebuild = train_mod.ModelTrainer._rebuild_model
    # FSDP2's collectives, under each name this torch has (the newer
    # all_gather_single / reduce_scatter_single, the older names, which may
    # call them: only the outermost call counts)
    names = [n for n in ("all_gather_single", "all_gather_into_tensor",
                         "reduce_scatter_single", "reduce_scatter_tensor")
             if hasattr(tdist, n)]
    collectives = {n: getattr(tdist, n) for n in names}
    moved = {"all_gather": 0, "reduce_scatter": 0, "all_gather_calls": 0,
             "reduce_scatter_calls": 0}
    depth = [0]
    record["probes"] = []

    def counted(name):
        """The collective, adding the bytes of each rank's whole tensor
        (the gathered output; the input before the reduce-scatter)."""
        fn = collectives[name]
        kind = "all_gather" if name.startswith("all_gather") \
            else "reduce_scatter"
        arg, pos = (("output_tensor", 0) if kind == "all_gather"
                    else ("input", 1))

        def call(*args, **kwargs):
            if not depth[0]:
                t = kwargs[arg] if arg in kwargs else args[pos]
                moved[kind] += t.numel() * t.element_size()
                moved[f"{kind}_calls"] += 1
            depth[0] += 1
            try:
                return fn(*args, **kwargs)
            finally:
                depth[0] -= 1
        return call

    for n in names:
        setattr(tdist, n, counted(n))

    def allocated_gib() -> float:
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated() / 2**30

    def watched_fit(self, *args, **kwargs):
        record["allocated"] = {"fit": allocated_gib(), "rebuilt": []}
        return fit(self, *args, **kwargs)

    def watched_rebuild(self, *args, **kwargs):
        rebuild(self, *args, **kwargs)
        record["allocated"]["rebuilt"].append(allocated_gib())

    def probe_step(self, batch):
        entry = {"micro_batch": self.cfg.training.per_device_train_batch_size,
                 "outcome": "fits"}
        before = dict(kernels.launch_counts)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        entry["at_start"] = torch.cuda.memory_allocated() / 2**30
        t1 = time.perf_counter()
        try:
            probe(self, batch)
        except Exception as e:
            entry["outcome"] = type(e).__name__
            raise
        finally:
            torch.cuda.synchronize()
            entry.update(
                ms=(time.perf_counter() - t1) * 1e3,
                peak=torch.cuda.max_memory_allocated() / 2**30,
                reserved=torch.cuda.max_memory_reserved() / 2**30,
                launches={k: v - before[k]
                          for k, v in kernels.launch_counts.items()},
                # what the probe leaves: FSDP2's comms, the TP switch
                comms_after=sorted({
                    type(c).__name__ for m in self.model.modules()
                    if isinstance(m, FSDPModule)
                    for g in _fsdp_param_groups(m)
                    for c in (g._all_gather_comm, g._reduce_scatter_comm)}),
                local_only_after=tp_mod.local_only["on"])
            record["probes"].append(entry)

    def grad_bytes(trainer):
        return sum(local(p).numel() * 4 for p in trainer.tx.params)

    def watched_unfreeze(self):
        unfreeze(self)
        record["grad_bytes"][self.state.phase] = grad_bytes(self)

    def train(self, it):
        stream = self.metrics_logger

        class Recorder:
            def log(self, metrics, step):
                record["logged"].append(
                    {"step": step, **{k: float(v)
                                      for k, v in metrics.items()}})
                stream.log(metrics, step)

            def close(self):
                stream.close()

        def digested(batches):
            for b in batches:
                record["batches"].append(hashlib.sha1(
                    b["input_features"].tobytes()
                    + b["stno_mask"].tobytes()).hexdigest())
                yield b

        self.metrics_logger = Recorder()
        record["grad_bytes"] = {self.state.phase: grad_bytes(self)}
        record["batches"] = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        record["loop_start"] = t1
        at_start = dict(moved)
        out = loop(self, digested(it))
        torch.cuda.synchronize()
        record["loop"] = time.perf_counter() - t1
        record["peak"] = torch.cuda.max_memory_allocated() / 2**30
        record["fsdp_bytes"] = {k: moved[k] - at_start[k] for k in moved}
        record["base_updates"] = getattr(self.tx, "inner", self.tx).count
        record["micro_batch"] = self.cfg.training.per_device_train_batch_size
        record["accum"] = self.cfg.training.gradient_accumulation_steps
        record["checksums"] = _checksums(local(p) for p in self.tx.params)
        if is_sharded(self.model):
            state = full_state_dict(self.model, to_cpu=False)
            record["gathered_checksums"] = _checksums(
                state[k] for k in sorted(state))
            del state
        names = {id(p): n for n, p in self.model.named_parameters()}
        tp = model_group(self.model) is not None
        record["sliced"] = [tp and tp_dim(names[id(p)]) is not None
                            for p in self.tx.params]
        return out

    trainer_mod.Trainer.train = train
    trainer_mod.Trainer._maybe_unfreeze = watched_unfreeze
    trainer_mod.Trainer.probe_step = probe_step
    train_mod.ModelTrainer._fit = watched_fit
    train_mod.ModelTrainer._rebuild_model = watched_rebuild

    def restore():
        trainer_mod.Trainer.train = loop
        trainer_mod.Trainer._maybe_unfreeze = unfreeze
        trainer_mod.Trainer.probe_step = probe
        train_mod.ModelTrainer._fit = fit
        train_mod.ModelTrainer._rebuild_model = rebuild
        for n, fn in collectives.items():
            setattr(tdist, n, fn)
    return restore


def child(spec_path: str) -> int:
    """One rank of phases 20-26 and 28, started by torchrun: the CLI's main
    with the spec's argv, the launch counts and the TP all-reduce bytes set
    to 0 just before and read just after, the eval batches this rank collates
    and its encoder calls counted; with the spec's ``flash_sites``, the
    q, k, v of the first encoder layer's self-attention and of the first
    SCB's cross-attention are kept as the flash forward receives them in
    their first forward under grad and, after the run, the flash kernels
    held against their plain versions on them (local heads under tensor
    parallelism); with the spec's ``memory_fraction``
    for this rank, its share of the card's memory is capped before the CLI
    starts; its record goes to <out>/rank<RANK>.json."""
    from ts_asr_whisper_tpu_torch import __main__ as cli
    from ts_asr_whisper_tpu_torch import decode, kernels
    from ts_asr_whisper_tpu_torch.models.dicow import SCB, DiCoWEncoder
    from ts_asr_whisper_tpu_torch.models.whisper import (DecoderLayer,
                                                         EncoderLayer)
    from ts_asr_whisper_tpu_torch.ops import attention
    from ts_asr_whisper_tpu_torch.parallel import tensor as tp_mod

    import faulthandler

    faulthandler.enable()  # a crash of a rank prints its Python stack
    spec = json.loads(Path(spec_path).read_text())
    rank = int(os.environ.get("RANK", "0"))
    fraction = spec.get("memory_fraction", {}).get(str(rank))
    if fraction is not None:
        torch.cuda.set_per_process_memory_fraction(fraction)
    record = {"logged": [], "decoded": [], "encoder_calls": 0,
              "entered": time.time(), "memory_fraction": fraction}
    _record_trainer(record)
    eval_batches = decode.eval_batches

    def counted_batches(*args, **kwargs):
        for bi, batch in eval_batches(*args, **kwargs):
            record["decoded"].append(bi)
            yield bi, batch

    sites, active = {}, []

    def site_kind(module):
        if isinstance(module, DecoderLayer):
            return None
        return next((kind for kind, cls in (("layer0", EncoderLayer),
                                             ("scb0", SCB))
                     if isinstance(module, cls)), None)

    def enter_site(module, args):
        kind = site_kind(module)
        if (spec.get("flash_sites") and kind and kind not in sites
                and torch.is_grad_enabled()):
            active.append(kind)

    flash_mha = attention.flash_mha

    def flash_at_sites(q, k, v):
        # the first flash call inside an encoder layer or an SCB: its self-
        # or cross-attention, on the main path's own q, k, v
        if active and active[-1] not in sites:
            sites[active[-1]] = (q.shape[-3], tuple(
                x.detach().clone() for x in (q, k, v)))
        return flash_mha(q, k, v)

    def count_encoder(module, args, output):
        if isinstance(module, DiCoWEncoder):
            record["encoder_calls"] += 1
        if active and site_kind(module) == active[-1]:
            active.pop()

    do_eval = decode.DecodeRunner.do_eval

    def timed_eval(self, *args, **kwargs):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = do_eval(self, *args, **kwargs)
        torch.cuda.synchronize()
        record["eval"] = record.get("eval", 0.0) + time.perf_counter() - t1
        return out

    decode.eval_batches = counted_batches
    decode.DecodeRunner.do_eval = timed_eval
    hooks = (torch.nn.modules.module.register_module_forward_pre_hook(
        enter_site),
        torch.nn.modules.module.register_module_forward_hook(count_encoder))
    attention.flash_mha = flash_at_sites
    for name in kernels.launch_counts:
        kernels.launch_counts[name] = 0
    for kind in tp_mod.reduced_bytes:
        tp_mod.reduced_bytes[kind] = 0
    t0 = time.perf_counter()
    try:
        metrics = cli.main(spec["argv"])
    finally:
        for hook in hooks:
            hook.remove()
        attention.flash_mha = flash_mha
    wall = time.perf_counter() - t0
    record.update(launches=dict(kernels.launch_counts),
                  tp_bytes=dict(tp_mod.reduced_bytes), wall=wall,
                  returned=time.time(), flash_sites={},
                  metrics={k: float(v) for k, v in (metrics or {}).items()})
    if "loop_start" in record:
        # the CLI's set-up before the training loop, and what follows it
        # (the HF export)
        record["setup"] = record.pop("loop_start") - t0
        record["after"] = wall - record["setup"] - record["loop"]
    for kind, (heads, (q, k, v)) in sorted(sites.items()):
        record["flash_sites"][kind] = {
            "heads": heads, "shape": list(q.shape),
            **check_flash_site(f"[rank {rank}] {kind} at {heads} local "
                               "heads", q, k, v, seed=7)}
    (Path(spec["out"]) / f"rank{rank}.json").write_text(json.dumps(record))
    return 0


def _launch(tag: str, argv: list, nproc: int, flash_sites: bool = False,
            memory_fraction: dict = None) -> dict:
    out = WORK / "ranks" / tag
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    spec = out / "spec.json"
    spec.write_text(json.dumps({
        "argv": argv, "out": str(out), "flash_sites": flash_sites,
        "memory_fraction": {str(r): f
                            for r, f in (memory_fraction or {}).items()}}))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(nproc), str(ROOT / "chip_smoke.py"),
           "--child", str(spec)]
    # the output goes to a file: a pipe that no one reads while another
    # launch is awaited would fill and stop the ranks
    with open(out / "log.txt", "w") as f:
        t0, launched = time.perf_counter(), time.time()
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=f,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
    return {"tag": tag, "nproc": nproc, "out": out, "proc": proc, "t0": t0,
            "launched": launched}


def _stop(proc: subprocess.Popen) -> None:
    """Stops a launcher and its ranks: SIGTERM first, which torchrun passes
    on to its ranks (each in a session of its own, out of reach of the
    launcher's group), then SIGKILL to what is left of the group."""
    os.killpg(proc.pid, signal.SIGTERM)
    try:
        proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        pass
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()


def run_ranks_together(*jobs: dict) -> list:
    """Launches that share the card at once, each ``python -m
    torch.distributed.run --standalone --nproc-per-node nproc chip_smoke.py
    --child <spec>``: the CLI on ``nproc`` ranks (each job is ``_launch``'s
    keyword arguments; rank r's memory capped at ``memory_fraction[r]`` of
    the card's). All start together, each is killed at CHILD_TIMEOUT, and
    the first that fails kills the others; any non-zero return code
    fails. Returns each launch's records, in the order of ``jobs``."""
    gc.collect()
    torch.cuda.empty_cache()
    started = []
    try:
        for job in jobs:
            started.append(_launch(**job))
        deadline = time.perf_counter() + CHILD_TIMEOUT
        while time.perf_counter() < deadline:
            for j in started:
                if "wall" not in j and j["proc"].poll() is not None:
                    j["wall"] = time.perf_counter() - j["t0"]
            if all("wall" in j for j in started) or any(
                    j["proc"].returncode for j in started):
                break
            time.sleep(0.2)
    finally:
        for j in started:
            if j["proc"].poll() is None:
                _stop(j["proc"])
                j["killed"] = True
    # a launch that failed on its own first, then one killed at the limit
    for j in sorted(started, key=lambda j: bool(j.get("killed"))):
        if j["proc"].returncode != 0:
            text = (j["out"] / "log.txt").read_text()
            if j.get("killed"):
                text += (f"\nkilled: timed out after {CHILD_TIMEOUT} s"
                         if time.perf_counter() >= deadline else
                         "\nkilled: another launch failed")
            raise AssertionError(f"[{j['tag']}] torchrun rc="
                                 f"{j['proc'].returncode}:\n{text[-6000:]}")
    beside = (f" beside {', '.join(j['tag'] for j in started[1:])}"
              if len(started) > 1 else "")
    results = []
    for i, j in enumerate(started):
        tag = j["tag"]
        wall, launched = j["wall"], j["launched"]
        recs = [json.loads((j["out"] / f"rank{r}.json").read_text())
                for r in range(j["nproc"])]
        log(f"[{tag}] {j['nproc']} rank(s) through torchrun"
            f"{beside if i == 0 else ''}, wall {wall:.1f} s: "
            f"{recs[0]['entered'] - launched:.1f} s to start (torchrun, "
            f"python, imports), {recs[0]['wall']:.1f} s in the CLI, "
            f"{launched + wall - recs[0]['returned']:.1f} s to exit")
        results.append(recs)
    return results


def _split_loss(n: int, multiple: int):
    """The training step's ``loss_fn`` as ``n`` data-parallel ranks take it,
    in one process: the micro-batch cut into ``n`` blocks of rows, as the
    DataLoader gives them to the ranks, each block's labels cut to the
    width that the collator gives those rows alone (their longest, rounded
    up to ``multiple``), each block's loss ``loss_fn``'s share of the whole
    micro-batch's (the global token count; ``n`` blocks).
    The backward of every block but the last runs here, so that each
    block's gradients are formed apart and then summed in fp32, as DDP
    sums the ranks'; the step's own backward adds the last block's.
    Returns the loss, the earlier blocks' detached, and the parts summed
    over the blocks, as the ranks log them."""
    from ts_asr_whisper_tpu_torch.training.trainer import loss_fn

    def split(model, model_cfg, batch, num_prefix_tokens, mesh=None):
        assert mesh is None
        n_tokens = (batch["labels"] != -100).sum().float().clamp_min(1.0)
        rows = batch["labels"].shape[0] // n
        total, parts = 0.0, {}
        for i in range(n):
            block = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
            longest = int((block["labels"] != -100).sum(1).max())
            width = -(-longest // multiple) * multiple
            for key in ("labels", "upp_labels"):
                if key in block:
                    block[key] = block[key][:, :width]
            t, p = loss_fn(model, model_cfg, block, num_prefix_tokens,
                           n_tokens=n_tokens, world=n)
            if i < n - 1:
                t.backward()
                t = t.detach()
            total = total + t
            parts = {k: parts.get(k, 0.0) + v.detach() for k, v in p.items()}
        return total, parts
    return split


def _unwrapped_runs(dev, overrides: list, n: int = 2, split: int = 1
                    ) -> list:
    """``n`` runs of the fine-tune's training loop in this process,
    unwrapped, from the same initial weights (ModelTrainer's, no export):
    the records of ``_record_trainer`` with the launch counts of each.
    With ``split`` > 1 each micro-batch is taken as that many data-
    parallel ranks take it (``_split_loss``)."""
    from ts_asr_whisper_tpu_torch import kernels
    from ts_asr_whisper_tpu_torch.config import load_config
    from ts_asr_whisper_tpu_torch.train import ModelTrainer
    from ts_asr_whisper_tpu_torch.training import trainer as trainer_mod
    from ts_asr_whisper_tpu_torch.training.lora import lora_linears

    gc.collect()
    torch.cuda.empty_cache()
    mt = ModelTrainer(load_config(overrides), dev)
    start = {k: v.to("cpu", copy=True)
             for k, v in mt.model.state_dict().items()}
    num_prefix = len(mt.container.tokenizer.prefix_tokens) - 1
    records = []
    for i in range(n):
        # the Trainer adds fresh LoRA adapters (from the seed) to a model
        # without them
        for _, m in list(lora_linears(mt.model)):
            del m.lora_A, m.lora_B, m.lora_scale
        mt.model.load_state_dict(start)
        record = {"logged": []}
        restore = _record_trainer(record)
        loss_fn = trainer_mod.loss_fn
        if split > 1:
            trainer_mod.loss_fn = _split_loss(
                split, mt.collator.pad_labels_to_multiple_of or 1)
        for name in kernels.launch_counts:
            kernels.launch_counts[name] = 0
        try:
            mt._fit(num_prefix, 0, None, None, None, None)
        finally:
            restore()
            trainer_mod.loss_fn = loss_fn
        record["launches"] = dict(kernels.launch_counts)
        what = f"split over {split}" if split > 1 else "unwrapped"
        log(f"[{what} {i + 1}] losses "
            f"{[round(r['loss'], 6) for r in record['logged']]}")
        records.append(record)
    del mt, start
    gc.collect()
    torch.cuda.empty_cache()
    return records


def _spread(recs: list) -> float:
    """The largest relative loss difference of any two of ``recs``."""
    return max(_max_rel(a["logged"], b["logged"])
               for i, a in enumerate(recs) for b in recs[i + 1:])


def _max_rel(a: list, b: list, key: str = "loss") -> float:
    if [r["step"] for r in a] != [r["step"] for r in b]:
        raise AssertionError(f"logged steps differ: {[r['step'] for r in a]}"
                             f" vs {[r['step'] for r in b]}")
    return max(abs(x[key] - y[key]) / abs(y[key]) for x, y in zip(a, b))


def _check_train_rank(tag: str, rec: dict, ref: dict, tol: float,
                      per_batch: int, steps: int,
                      fwd_tol: float = DP_FORWARD_TOL,
                      ref_name: str = "the unwrapped run's") -> None:
    diff = _max_rel(rec["logged"], ref["logged"])
    # accumulation 2: the first update follows micro-batch 2
    fwd = _max_rel(rec["logged"][:2], ref["logged"][:2])
    want = per_batch * steps
    got = tuple(rec["launches"][k] for k in ("flash_attn_fwd",
                                             "flash_attn_bwd"))
    # 4 preheat micro-batches, then 4 base ones, in updates of 2; the
    # optimizer built at the unfreeze counts the base updates
    if len(rec["logged"]) != steps or rec["base_updates"] != 2:
        raise AssertionError(f"[{tag}] {len(rec['logged'])} logged steps, "
                             f"{rec['base_updates']} base updates")
    if diff > tol or fwd > fwd_tol or not all(
            math.isfinite(r["loss"]) for r in rec["logged"]):
        raise AssertionError(
            f"[{tag}] losses {[r['loss'] for r in rec['logged']]} vs "
            f"{ref_name} {[r['loss'] for r in ref['logged']]}: relative "
            f"difference {fwd:.3g} before the first update (tolerance "
            f"{fwd_tol:.3g}), {diff:.3g} in all (tolerance {tol:.3g})")
    if got != (want, want):
        raise AssertionError(f"[{tag}] flash launches fwd/bwd {got}, want "
                             f"{want} ({per_batch} x {steps} micro-batches)")
    parts = (f", CLI set-up {rec['setup']:.1f} s, export {rec['after']:.1f} s"
             if "setup" in rec else "")
    log(f"[{tag}] losses within {fwd:.3g} of {ref_name} before the first "
        f"update (tolerance {fwd_tol:.3g}), {diff:.3g} in all (tolerance "
        f"{tol:.3g}); "
        f"flash fwd / bwd {got[0]} / {got[1]}; "
        f"training loop {rec['loop']:.2f} s, "
        f"{rec['loop'] * 1e3 / (steps // 2):.0f} ms per update, peak "
        f"{rec['peak']:.1f} GiB{parts}")


def _check_split_rank(tag: str, rec: dict, ctx: dict) -> None:
    """A rank of two DDP ranks at micro-batch 2 (phases 21 and 26) against
    ``dp_setup``'s runs split as its ranks split each micro-batch: within
    ctx["split_tol"] in all and DP_FORWARD_TOL before the first update, and
    within DP_FORWARD_TOL of the unwrapped run before it. That tolerance
    may lie above the split's own effect on the losses (the split runs
    against the unwrapped run), so the rank must also be nearer the split
    runs than the unwrapped run."""
    mc, steps = ctx["per_batch"], ctx["steps"]
    _check_train_rank(tag, rec, ctx["split_ref"], ctx["split_tol"], mc,
                      steps, ref_name="the split runs'")
    _check_train_rank(f"{tag} (unwrapped)", rec, ctx["ref"], math.inf, mc,
                      steps)
    split = _max_rel(rec["logged"], ctx["split_ref"]["logged"])
    unsplit = _max_rel(rec["logged"], ctx["ref"]["logged"])
    if split >= unsplit:
        raise AssertionError(
            f"[{tag}] losses {split:.3g} from the split runs', {unsplit:.3g} "
            f"from the unwrapped run's: the rank does not follow its split")
    log(f"[{tag}] {split:.3g} from the split runs, {unsplit:.3g} from the "
        f"unwrapped run; the tolerance {ctx['split_tol']:.3g} beside the "
        f"split's effect {ctx['split_effect']:.3g}")


def dp_context(dev) -> dict:
    """Phase 20's corpus (phase 9's), model dir (turbo width at DP_LAYERS
    encoder layers) and fine-tune overrides, which phases 20-26 and 28
    share."""
    from ts_asr_whisper_tpu_torch.data.synthetic import write_corpus

    work = WORK / "dp_train"
    shutil.rmtree(work, ignore_errors=True)
    manifest = write_corpus(work / "corpus", [30.0] * 8, seed=1)  # phase 9's
    model_dir = _depth_dir(work, DP_LAYERS)
    return {"dev": dev, "work": work, "steps": 8,
            # + the CTC head's self-attention
            "per_batch": DP_LAYERS + 1,
            "overrides": lambda name: [
                *train_overrides(manifest, model_dir, work / name), *NO_AUG]}


def _depth_dir(work: Path, layers: int) -> Path:
    """A model dir of the turbo config at ``layers`` encoder layers (the
    weights come from the seed), made once under ``work``."""
    model_dir = work / f"model_{layers}_layers"
    if not model_dir.exists():
        model_dir.mkdir(parents=True)
        (model_dir / "config.json").write_text(json.dumps(
            {**TURBO, "encoder_layers": layers}))
    return model_dir


def dp_setup(dev) -> dict:
    """``dp_context`` and two unwrapped runs of the fine-tune in this
    process: the reference and the loss tolerance of phases 20 and 23; and
    DP_SPLIT_RUNS runs with each micro-batch split as two data-parallel
    ranks split it (``_split_loss``): the reference and the loss tolerance
    of phase 21."""
    ctx = dp_context(dev)
    ref = _unwrapped_runs(dev, ctx["overrides"]("unwrapped"))
    spread = _max_rel(ref[1]["logged"], ref[0]["logged"])
    ctx.update(ref=ref[0], tol=max(DP_LOSS_FACTOR * spread, DP_LOSS_FLOOR))
    steps = ctx["steps"]
    log(f"[dp] two unwrapped runs: largest relative loss difference "
        f"{spread:.3g} -> tolerance {ctx['tol']:.3g}; ms per update "
        f"{ref[0]['loop'] * 1e3 / (steps // 2):.0f} / "
        f"{ref[1]['loop'] * 1e3 / (steps // 2):.0f}, peak "
        f"{ref[0]['peak']:.1f} / {ref[1]['peak']:.1f} GiB")
    for r in ref:
        _check_train_rank("unwrapped", r, ref[0], ctx["tol"],
                          ctx["per_batch"], steps)
    # each rank's bf16 weight gradients over its own 2 rows move the losses
    # from the unwrapped run's by more than a pair of unwrapped runs
    # samples (1.30e-4 against a tolerance of 1.66e-4 once: PERF.md §6):
    # phase 21 is held to runs on its own split, within 10 x the larger
    # spread of the split runs and of the unwrapped pair
    split = _unwrapped_runs(dev, ctx["overrides"]("split"), n=DP_SPLIT_RUNS,
                            split=2)
    split_spread = _spread(split)
    ctx.update(split_ref=split[0], split_tol=max(
        DP_LOSS_FACTOR * max(split_spread, spread), DP_LOSS_FLOOR),
        split_effect=_max_rel(split[0]["logged"], ref[0]["logged"]))
    log(f"[dp] {DP_SPLIT_RUNS} runs split over 2 ranks' rows: largest "
        f"relative loss difference of a pair {split_spread:.3g} -> "
        f"tolerance {ctx['split_tol']:.3g}; the split's effect, split run 1 "
        f"against unwrapped run 1: {ctx['split_effect']:.3g}")
    for r in split:
        # the flash kernels run once a block of rows
        _check_train_rank("split", r, split[0], ctx["split_tol"],
                          2 * ctx["per_batch"], steps)
        _check_train_rank("split (unwrapped)", r, ref[0], math.inf,
                          2 * ctx["per_batch"], steps)
    return ctx


def phase_dp_train(ctx: dict) -> dict:
    """Phases 20 and 21 (see the module docstring)."""
    ref, tol, mc, steps = (ctx[k] for k in ("ref", "tol", "per_batch",
                                             "steps"))
    overrides = ctx["overrides"]
    paths = {}
    # the three launches share the card at once (their ms per update so
    # too); phase 21's: two ranks over gloo, micro-batches of 2
    tags = ("ddp_nccl", "fsdp_nccl")
    *runs, recs = run_ranks_together(*(dict(
        tag=tag, nproc=1, argv=["--device", "cuda", *overrides(tag),
                                f"training.shard_params={str(shard).lower()}"])
        for shard, tag in zip((False, True), tags)), dict(
        tag="ddp_gloo_2ranks", nproc=2, argv=[
            "--device", "cuda:0", "--backend", "gloo", *overrides("gloo")]))
    for tag, (rec,) in zip(tags, runs):
        _check_train_rank(tag, rec, ref, tol, mc, steps)
        paths[f"dicow_v3_train_{tag}"] = rec["launches"]

    # phase 21, held to the runs on the same split
    if recs[0]["logged"] != recs[1]["logged"]:
        raise AssertionError(f"[ddp_gloo_2ranks] the ranks logged "
                             f"{recs[0]['logged']} and {recs[1]['logged']}")
    for rank, rec in enumerate(recs):
        _check_split_rank(f"ddp_gloo rank {rank}", rec, ctx)
    ctx["ddp_gloo"] = recs  # phase 26's reference
    if recs[0]["checksums"] != recs[1]["checksums"]:
        bad = sum(a != b for a, b in zip(recs[0]["checksums"],
                                         recs[1]["checksums"]))
        raise AssertionError(f"[ddp_gloo_2ranks] {bad} parameter checksums "
                             "differ between the ranks")
    gb = recs[0]["grad_bytes"]
    log(f"[ddp_gloo_2ranks] {len(recs[0]['checksums']) // 2} trainable "
        f"tensors with equal checksums on both ranks; all-reduce per "
        f"micro-batch: preheat {gb['preheat'] / 1e6:.1f} MB, base "
        f"{gb['base'] / 1e9:.3f} GB of fp32 gradients (+ 4 B token count)")
    paths["dicow_v3_train_ddp_gloo_2ranks"] = _summed(recs)
    return paths


def phase_lora_fsdp(ctx: dict, beside: dict) -> dict:
    """Phase 25 (see the module docstring), launched beside phase 26's
    ranks (``beside``: autobatch_job's job and check)."""
    steps = LORA_FSDP_STEPS
    mc = ctx["per_batch"]

    def overrides(name):
        return [*ctx["overrides"](name), "training.use_lora=true",
                f"training.max_steps={steps}",
                "training.use_fddt_only_n_steps=0"]

    ref = _unwrapped_runs(ctx["dev"], overrides("lora_unwrapped"),
                          n=LORA_FSDP_RUNS)
    spread = _spread(ref)
    tol = max(DP_LOSS_FACTOR * spread, DP_LOSS_FLOOR)
    log(f"[lora fsdp] {LORA_FSDP_RUNS} unwrapped LoRA runs: largest relative "
        f"loss difference of a pair {spread:.3g} -> tolerance {tol:.3g}; ms "
        f"per update "
        + " / ".join(f"{r['loop'] * 1e3 / (steps // 2):.0f}" for r in ref)
        + ", peak " + " / ".join(f"{r['peak']:.1f}" for r in ref) + " GiB")
    for r in ref:
        _check_train_rank("lora unwrapped", r, ref[0], tol, mc, steps)
    # the same split of each micro-batch over 2 ranks under DDP: FSDP2's
    # reference (each rank's bf16 weight gradients over its 2 rows, which
    # Adam's first update on B = 0 turns into sign-sized steps, are noise
    # that no unwrapped pair samples)
    tags = ("lora_ddp_gloo_2ranks", "lora_fsdp_gloo_2ranks")
    # the three launches share the card at once (their ms per update so too)
    *pair, auto = run_ranks_together(*(dict(
        tag=tag, nproc=2, flash_sites=shard, argv=[
            "--device", "cuda:0", "--backend", "gloo", *overrides(tag),
            f"training.shard_params={str(shard).lower()}"])
        for shard, tag in zip((False, True), tags)), beside["job"])
    runs = dict(zip(tags, pair))
    for tag, recs in runs.items():
        if recs[0]["logged"] != recs[1]["logged"]:
            raise AssertionError(f"[{tag}] the ranks logged "
                                 f"{recs[0]['logged']} and "
                                 f"{recs[1]['logged']}")
    ddp, fsdp = runs["lora_ddp_gloo_2ranks"], runs["lora_fsdp_gloo_2ranks"]
    # before the first update: the unwrapped run's forward
    _check_train_rank("lora_ddp_gloo_2ranks rank 0", ddp[0], ref[0],
                      math.inf, mc, steps)
    for rank, rec in enumerate(fsdp):
        _check_train_rank(f"lora_fsdp_gloo_2ranks rank {rank}", rec, ddp[0],
                          tol, mc, steps)
        _check_train_rank(f"lora_fsdp_gloo_2ranks rank {rank} (unwrapped)",
                          rec, ref[0], math.inf, mc, steps)
    sums = [r["gathered_checksums"] for r in fsdp]
    if sums[0] != sums[1]:
        bad = sum(a != b for a, b in zip(*sums))
        raise AssertionError(f"[lora fsdp] {bad} checksums of the gathered "
                             "state differ between the ranks")
    moved = fsdp[0]["fsdp_bytes"]
    log(f"[lora fsdp] FSDP2 held against DDP on the same split within the "
        f"tolerance; the {len(sums[0]) // 2} gathered tensors (adapters and "
        f"weights) have equal checksums on both ranks; per micro-batch and "
        f"rank: all-gather {moved['all_gather'] / steps / 1e9:.3f} GB in "
        f"{moved['all_gather_calls'] / steps:.0f} calls, reduce-scatter "
        f"{moved['reduce_scatter'] / steps / 1e9:.3f} GB in "
        f"{moved['reduce_scatter_calls'] / steps:.0f} calls (each rank's "
        f"whole tensors); ms per update FSDP2 "
        + " / ".join(f"{r['loop'] * 1e3 / (steps // 2):.0f}" for r in fsdp)
        + ", DDP " + " / ".join(f"{r['loop'] * 1e3 / (steps // 2):.0f}"
                                for r in ddp)
        + "; peak FSDP2 " + " / ".join(f"{r['peak']:.1f}" for r in fsdp)
        + ", DDP " + " / ".join(f"{r['peak']:.1f}" for r in ddp) + " GiB")
    return {"dicow_v3_lora_ddp_gloo_2ranks": _summed(ddp),
            "dicow_v3_lora_fsdp_gloo_2ranks": _summed(fsdp),
            **beside["check"](auto)}


def _probe_lines(tag: str, recs: list, total: float) -> None:
    """Each rank's memory probes: outcome, ms, memory at the start and the
    peak, flash launches; and the memory allocated when the fine-tune
    started and after each rebuild of its model."""
    for rank, rec in enumerate(recs):
        cap = (f"capped at {rec['memory_fraction'] * total:.1f} GiB"
               if rec["memory_fraction"] else "uncapped")
        alloc = rec["allocated"]
        log(f"[{tag}] rank {rank} ({cap}) probes: " + "; ".join(
            f"micro-batch {p['micro_batch']} {p['outcome']} in "
            f"{p['ms']:.0f} ms, {p['at_start']:.2f} GiB at its start, peak "
            f"{p['peak']:.2f} GiB (reserved {p['reserved']:.2f}), flash fwd "
            f"/ bwd "
            f"{p['launches']['flash_attn_fwd']} / "
            f"{p['launches']['flash_attn_bwd']}" for p in rec["probes"])
            + f"; allocated {alloc['fit']:.3f} GiB before the first attempt"
            + "".join(f", {g:.3f} after a rebuild" for g in alloc["rebuilt"]))


def _check_autobatch(tag: str, recs: list, capped: int, total: float,
                     layers: int, steps: int) -> None:
    """The checks of an auto_find_batch_size launch from micro-batch 4 and
    accumulation 1 over ``steps`` micro-batches of a model of ``layers``
    encoder layers, whose rank ``capped`` is capped between its probes'
    peaks at 2 and 4: every rank's probes are [(4, out of memory on the
    capped rank, fits on the others), (2, fits)], every rank trained at
    micro-batch 2 and accumulation 2, the ranks logged the same finite
    losses at every micro-batch, each rank's model came back after the
    rebuild to the memory that it held when the first attempt started
    (within REBUILD_SLACK_GIB), no micro-batch of the training loop peaked
    above the last probe (the design's claim), and the loop launched the
    flash forward and backward in every encoder layer and the CTC head of
    every micro-batch; after each probe, FSDP2 holds its default comms
    again and the tensor-parallel all-reduces are real again."""
    _probe_lines(tag, recs, total)
    for rank, rec in enumerate(recs):
        left = {(tuple(p["comms_after"]), p["local_only_after"])
                for p in rec["probes"]}
        if not left <= {((), False), (("DefaultAllGather",
                                       "DefaultReduceScatter"), False)}:
            raise AssertionError(f"[{tag}] rank {rank}: after its probes "
                                 f"the comms and TP switch were {left}")
        outcomes = [(p["micro_batch"], p["outcome"]) for p in rec["probes"]]
        first = "OutOfMemoryError" if rank == capped else "fits"
        if outcomes != [(4, first), (2, "fits")] or \
                (rec["micro_batch"], rec["accum"]) != (2, 2):
            raise AssertionError(
                f"[{tag}] rank {rank}: probes {outcomes}, trained at micro-"
                f"batch {rec['micro_batch']}, accumulation {rec['accum']}")
        alloc = rec["allocated"]
        if len(alloc["rebuilt"]) != 1 or \
                abs(alloc["rebuilt"][0] - alloc["fit"]) > REBUILD_SLACK_GIB:
            raise AssertionError(
                f"[{tag}] rank {rank}: {alloc['fit']:.3f} GiB allocated "
                f"before the first attempt, {alloc['rebuilt']} after the "
                "rebuild")
    logged = recs[0]["logged"]
    if any(r["logged"] != logged for r in recs) or len(logged) != steps \
            or not all(math.isfinite(r["loss"]) for r in logged):
        raise AssertionError(f"[{tag}] the ranks logged "
                             f"{[r['logged'] for r in recs]}")
    want = (layers + 1) * steps  # + the CTC head's self-attention
    got = [tuple(r["launches"][k] - sum(p["launches"][k] for p in r["probes"])
                 for k in ("flash_attn_fwd", "flash_attn_bwd")) for r in recs]
    if any(g != (want, want) for g in got):
        raise AssertionError(f"[{tag}] the training loop's flash fwd / bwd "
                             f"launches per rank {got}, want {want}")
    if any(r["peak"] > r["probes"][-1]["peak"] for r in recs):
        raise AssertionError(
            f"[{tag}] the training loop peaked at "
            f"{[r['peak'] for r in recs]} GiB, over its probe's "
            f"{[r['probes'][-1]['peak'] for r in recs]}")
    log(f"[{tag}] every rank halved together to micro-batch 2, accumulation "
        f"2, and logged the same losses; flash fwd / bwd {want} / {want} a "
        f"rank in the training loop; its peak "
        + " / ".join(f"{r['peak']:.2f}" for r in recs) + " GiB under the "
        "probe's at micro-batch 2, "
        + " / ".join(f"{r['probes'][-1]['peak']:.2f}" for r in recs)
        + "; ms per update " + " / ".join(
            f"{r['loop'] * 1e3 / (steps // 2):.0f}" for r in recs))


def autobatch_job(ctx: dict, micro: int = 4, capped: bool = True) -> dict:
    """Phase 26 (see the module docstring): the launch ``job`` (from
    ``micro`` rows, rank 1 held to AUTOBATCH_CAP_GIB when ``capped``) and
    the ``check`` of its records, which phase 25 runs beside its own
    launches."""
    tag = "autobatch_gloo_2ranks"
    total = torch.cuda.get_device_properties(0).total_memory / 2**30
    job = dict(tag=tag, nproc=2,
               memory_fraction={1: AUTOBATCH_CAP_GIB / total} if capped
               else None,
               argv=["--device", "cuda:0", "--backend", "gloo",
                     *ctx["overrides"]("autobatch"),
                     "training.overall_batch_size=0",
                     f"training.per_device_train_batch_size={micro}",
                     "training.gradient_accumulation_steps=1",
                     "training.auto_find_batch_size=true"])

    def check(recs: list) -> dict:
        _check_autobatch(tag, recs, 1, total, DP_LAYERS, ctx["steps"])
        # after the halving it runs phase 21's settings: held to its
        # references and to its losses
        tol, p21 = ctx["split_tol"], ctx["ddp_gloo"][0]["logged"]
        for rank, rec in enumerate(recs):
            # the training loop's launches: the probes' apart
            loop = dict(rec, launches={
                k: v - sum(p["launches"][k] for p in rec["probes"])
                for k, v in rec["launches"].items()})
            _check_split_rank(f"{tag} rank {rank}", loop, ctx)
        diff = _max_rel(recs[0]["logged"], p21)
        if diff > tol:
            raise AssertionError(f"[{tag}] losses {diff:.3g} from phase 21's "
                                 f"(tolerance {tol:.3g})")
        log(f"[{tag}] losses within {diff:.3g} of phase 21's (tolerance "
            f"{tol:.3g})")
        return {"dicow_v3_train_autobatch_gloo_2ranks": _summed(recs)}
    return {"job": job, "check": check}


def autobatch_sharded_jobs(ctx: dict, micro: int = 4, capped: bool = True
                           ) -> list:
    """Phase 28's two launches (run_ranks_together's jobs): the fine-tune
    with auto_find_batch_size=true and FSDP2 from ``micro`` rows and
    accumulation 1 over AUTOBATCH_SHARDED_STEPS micro-batches of the base
    phase (no preheat), at full width and the depth of each entry of
    AUTOBATCH_SHARDED, its capped rank held to its cap when ``capped``."""
    total = torch.cuda.get_device_properties(0).total_memory / 2**30
    jobs = []
    for tag, layers, shape, rank, cap in AUTOBATCH_SHARDED:
        model_dir = _depth_dir(ctx["work"], layers)
        mesh = [f"training.mesh_shape=[{','.join(map(str, shape))}]"]
        if len(shape) == 2:
            mesh.append("training.mesh_axis_names=[data,model]")
        jobs.append(dict(
            tag=tag, nproc=math.prod(shape),
            memory_fraction={rank: cap / total} if capped else None,
            argv=["--device", "cuda:0", "--backend", "gloo",
                  *ctx["overrides"](tag), f"model.whisper_model={model_dir}",
                  "training.overall_batch_size=0",
                  f"training.per_device_train_batch_size={micro}",
                  "training.gradient_accumulation_steps=1",
                  f"training.max_steps={AUTOBATCH_SHARDED_STEPS}",
                  "training.use_fddt_only_n_steps=0",
                  "training.auto_find_batch_size=true",
                  "training.shard_params=true", *mesh]))
    return jobs


def phase_autobatch_sharded(ctx: dict) -> dict:
    """Phase 28 (see the module docstring)."""
    total = torch.cuda.get_device_properties(0).total_memory / 2**30
    paths = {}
    for (tag, layers, _, capped, _), recs in zip(
            AUTOBATCH_SHARDED,
            run_ranks_together(*autobatch_sharded_jobs(ctx))):
        _check_autobatch(tag, recs, capped, total, layers,
                         AUTOBATCH_SHARDED_STEPS)
        paths[tag] = _summed(recs)
    return paths


def _summed(recs: list) -> dict:
    """The ranks' launch counts, summed per kernel."""
    return {k: sum(r["launches"][k] for r in recs)
            for k in recs[0]["launches"]}


def _equal_replicated(tag: str, recs: list) -> int:
    """The checksums of every trainable tensor that is whole on each rank
    (not a TP slice) are equal on all ranks; returns their count."""
    flags = recs[0]["sliced"]
    whole = [t for t, sliced in enumerate(flags) if not sliced]
    # two checksums a tensor
    bad = [t for t in whole
           if len({tuple(r["checksums"][2 * t:2 * t + 2]) for r in recs}) > 1]
    if bad or any(r["sliced"] != flags for r in recs):
        raise AssertionError(f"[{tag}] {len(bad)} replicated tensors differ "
                             "between the ranks")
    return len(whole)


def _tp_rank_line(tag: str, recs: list, steps: int) -> str:
    tb = recs[0]["tp_bytes"]
    ms = " / ".join(f"{r['loop'] * 1e3 / (steps // 2):.0f}" for r in recs)
    peak = " / ".join(f"{r['peak']:.1f}" for r in recs)
    return (f"[{tag}] TP all-reduce per micro-batch and rank: forward "
            f"{tb['forward'] / steps / 1e9:.3f} GB (fp32 row-parallel "
            f"sums), backward {tb['backward'] / steps / 1e9:.3f} GB (bf16 "
            f"input gradients), {tb['whole_grads'] / steps / 1e9:.3f} GB "
            f"(fp32 gradients of the whole tensors); ms per update {ms}, "
            f"peak {peak} GiB")


def phase_tp_train(ctx: dict, beside: dict) -> dict:
    """Phase 23 (see the module docstring), launched beside phase 22's
    ranks (``beside``: phase_sharded_eval's job and check)."""
    from safetensors.torch import load_file

    from ts_asr_whisper_tpu_torch.config import load_config
    from ts_asr_whisper_tpu_torch.models.containers import WhisperContainer

    ref, tol, mc, steps = (ctx[k] for k in ("ref", "tol", "per_batch",
                                             "steps"))
    tag = "tp_1x2"
    recs, sharded = run_ranks_together(
        dict(tag=tag, nproc=2, flash_sites=True, argv=[
            "--device", "cuda:0", "--backend", "gloo",
            *ctx["overrides"]("tp"), "training.mesh_shape=[1,2]",
            "training.mesh_axis_names=[data,model]"]),
        beside["job"])
    paths = beside["check"](sharded)
    if recs[0]["logged"] != recs[1]["logged"]:
        raise AssertionError(f"[{tag}] the ranks logged {recs[0]['logged']} "
                             f"and {recs[1]['logged']}")
    if recs[0]["batches"] != recs[1]["batches"]:
        raise AssertionError(f"[{tag}] the model peers read other batches")
    for rank, rec in enumerate(recs):
        _check_train_rank(f"{tag} rank {rank}", rec, ref, tol, mc, steps,
                          fwd_tol=TP_FORWARD_TOL)
        site = rec["flash_sites"]["layer0"]
        heads = TURBO["encoder_attention_heads"] // 2
        if site["heads"] != heads or site["shape"] != [
                4, heads, 1500, TURBO["d_model"] // (2 * heads)]:
            raise AssertionError(f"[{tag}] rank {rank} layer 0 at "
                                 f"{site['heads']} heads, q {site['shape']}")
    n_whole = _equal_replicated(tag, recs)
    # the gathered export loads strictly into one process's container
    export = ctx["work"] / "tp" / "hf_export"
    cfg = load_config(["+train=dicow_v3", f"model.whisper_model={export}",
                       "model.reinit_encoder_from=null",
                       "data.train_cutsets=[]", "data.dev_cutsets=[]",
                       "data.eval_cutsets=[]"])
    container = WhisperContainer(cfg, ctx["dev"])
    sd = load_file(str(export / "model.safetensors"))
    q = "model.encoder.layers.0.self_attn.q_proj.weight"
    if tuple(sd[q].shape) != (TURBO["d_model"],) * 2:
        raise AssertionError(f"[{tag}] export {q} {tuple(sd[q].shape)}")
    del container, sd
    log(f"[{tag}] both ranks logged bit-identical losses and gradient "
        f"norms {[round(r['loss'], 6) for r in recs[0]['logged']]}; "
        f"{n_whole} replicated trainable tensors with equal checksums; the "
        f"gathered export loads strictly into one process's container")
    log(_tp_rank_line(tag, recs, steps))
    return {**paths, "dicow_v3_train_tp_1x2": _summed(recs)}


def phase_tp_se_dicow(dev) -> dict:
    """Phase 24 (see the module docstring)."""
    from ts_asr_whisper_tpu_torch.config import load_config
    from ts_asr_whisper_tpu_torch.data.synthetic import write_corpus
    from ts_asr_whisper_tpu_torch.models.containers import WhisperContainer
    from ts_asr_whisper_tpu_torch.training.checkpoints import \
        export_hf_checkpoint

    work = WORK / "tp_se_dicow"
    shutil.rmtree(work, ignore_errors=True)
    manifest = write_corpus(work / "corpus", [30.0] * 4, seed=2)
    model_dir = work / "model"
    model_dir.mkdir(parents=True)
    (model_dir / "config.json").write_text(json.dumps(
        {**TURBO, "encoder_layers": TP_SE_LAYERS}))
    steps = 8  # 4 preheat micro-batches, then 4 base ones, in updates of 2

    def overrides(name):
        return ["+train=se_dicow", f"model.whisper_model={model_dir}",
                f"model.scb_layers={TP_SE_SCBS}",
                "model.reinit_encoder_from=null",
                f"data.train_cutsets=[{manifest}]", "data.dev_cutsets=[]",
                "data.eval_cutsets=[]", "data.enrollment_cutsets=[]",
                "data.dataset_weights=null", "aug.musan_root=null",
                "training.overall_batch_size=8",
                "training.gradient_accumulation_steps=2",
                f"training.max_steps={steps}",
                "training.use_fddt_only_n_steps=4", "training.warmup_steps=0",
                "training.eval_strategy=no", "training.save_strategy=no",
                "training.logging_steps=1",
                f"training.output_dir={work / name}", *NO_AUG]

    # the model's weights from the seed with every SCB gate opened (a fresh
    # gate is 0 and stops every SCB gradient), saved for all the runs
    container = WhisperContainer(load_config(overrides("init")), dev)
    with torch.no_grad():
        for i, scb in enumerate(container.model.encoder.ca_enrolls):
            scb.cae.cross_gate.gate.fill_(0.3 + 0.05 * i)
    export_hf_checkpoint(container.model.state_dict(),
                         container.model_config, str(model_dir))
    del container
    gc.collect()
    torch.cuda.empty_cache()
    ref = _unwrapped_runs(dev, overrides("unwrapped"), n=TP_SE_RUNS)
    spread = _spread(ref)
    tol = max(DP_LOSS_FACTOR * spread, DP_LOSS_FLOOR)
    per_batch = TP_SE_LAYERS + TP_SE_SCBS + 1  # + the CTC head
    log(f"[tp se_dicow] {TP_SE_RUNS} unwrapped runs: largest relative loss "
        f"difference of a pair {spread:.3g} -> tolerance {tol:.3g}")
    for r in ref:
        _check_train_rank("tp se_dicow unwrapped", r, ref[0], tol, per_batch,
                          steps)
    tag = "tp_2x2"
    # the reference after the first update: DDP over 2 ranks, the same
    # split of every micro-batch as the data coordinates' (each rank's bf16
    # weight gradients over its 2 rows move the losses, by up to 5.1e-4,
    # which no unwrapped pair samples), launched beside the TP run
    recs, ddp = run_ranks_together(
        dict(tag=tag, nproc=4, flash_sites=True, argv=[
            "--device", "cuda:0", "--backend", "gloo", *overrides("tp"),
            "training.mesh_shape=[2,2]",
            "training.mesh_axis_names=[data,model]"]),
        dict(tag="ddp_2ranks", nproc=2, argv=[
            "--device", "cuda:0", "--backend", "gloo", *overrides("ddp")]))
    if ddp[0]["logged"] != ddp[1]["logged"]:
        raise AssertionError(f"[tp se_dicow ddp] the ranks logged "
                             f"{ddp[0]['logged']} and {ddp[1]['logged']}")
    # before the first update: the unwrapped run's forward
    for rank, rec in enumerate(ddp):
        _check_train_rank(f"tp se_dicow ddp rank {rank} (unwrapped)", rec,
                          ref[0], math.inf, per_batch, steps)
    n_ddp = _equal_replicated("tp se_dicow ddp", ddp)
    # rank = d * tp + m: ranks 0, 1 hold data coordinate 0, ranks 2, 3 hold
    # 1, and DDP's rank d reads the rows of data coordinate d
    if not (recs[0]["batches"] == recs[1]["batches"] == ddp[0]["batches"]
            and recs[2]["batches"] == recs[3]["batches"] == ddp[1][
                "batches"]) or any(
                a == b for a, b in zip(recs[0]["batches"],
                                       recs[2]["batches"])):
        raise AssertionError(f"[{tag}] batches {[r['batches'] for r in recs]}"
                             f", DDP's {[r['batches'] for r in ddp]}")
    for rank, rec in enumerate(recs):
        if rec["logged"] != recs[0]["logged"]:
            raise AssertionError(f"[{tag}] rank {rank} logged "
                                 f"{rec['logged']}, rank 0 "
                                 f"{recs[0]['logged']}")
        _check_train_rank(f"{tag} rank {rank}", rec, ddp[0], tol, per_batch,
                          steps, fwd_tol=TP_FORWARD_TOL)
        _check_train_rank(f"{tag} rank {rank} (unwrapped)", rec, ref[0],
                          math.inf, per_batch, steps, fwd_tol=TP_FORWARD_TOL)
        site = rec["flash_sites"]["scb0"]
        if site["heads"] != TURBO["encoder_attention_heads"] // 2:
            raise AssertionError(f"[{tag}] rank {rank}: SCB 0 at "
                                 f"{site['heads']} heads")
    n_whole = _equal_replicated(tag, recs)
    log(f"[{tag}] data coordinates read different rows (DDP's ranks the "
        f"same), the model peers the same; held against DDP on the same "
        f"split within the tolerance after the first update; DDP "
        f"{_max_rel(ddp[0]['logged'], ref[0]['logged']):.3g} from the "
        f"unwrapped run in all ({n_ddp} trainable tensors with equal "
        f"checksums on both ranks); every rank logged the global losses "
        f"{[round(r['loss'], 6) for r in recs[0]['logged']]}; {n_whole} "
        f"replicated trainable tensors with equal checksums; SCB 0 at "
        f"{recs[0]['flash_sites']['scb0']['shape']}")
    log(_tp_rank_line(tag, recs, steps))
    shutil.rmtree(work, ignore_errors=True)
    return {"se_dicow_train_tp_2x2": _summed(recs),
            "se_dicow_train_ddp_2ranks": _summed(ddp)}


def phase_sharded_eval(dev) -> dict:
    """Phase 22 (see the module docstring): the single-process decode, then
    the launch ``job`` and the ``check`` of its records, which phase 23
    runs beside its own launch."""
    gc.collect()
    torch.cuda.empty_cache()
    overrides = ["+decode=dicow_v3_greedy",
                 "training.per_device_eval_batch_size=4"]
    # phase 7's recordings, decoded here at batch 4
    single = run_decode(dev, "greedy_b4", overrides, [60.0] * 8)
    manifest = single.pop("runner").cfg.data.eval_cutsets[0]
    gc.collect()
    torch.cuda.empty_cache()
    work = WORK / "greedy_b4"
    out = work / "exp_ranks"
    argv = ["--device", "cuda:0", "--backend", "gloo", *overrides,
            f"model.whisper_model={work / 'model'}",
            f"data.eval_cutsets=[{manifest}]",
            "training.generation_max_length=128",
            "training.save_visualizations=false", f"training.output_dir={out}"]
    return {"job": dict(tag="greedy_sharded_2ranks", argv=argv, nproc=2),
            "check": lambda recs: _check_sharded_eval(recs, single, work)}


def _check_sharded_eval(recs: list, single: dict, work: Path) -> dict:
    name = "eval_cutset"
    out = work / "exp_ranks"
    ref_metrics = single["metrics"]
    for rank, rec in enumerate(recs):
        if rec["decoded"] != [rank, rank + 2]:
            raise AssertionError(f"[sharded eval] rank {rank} decoded "
                                 f"batches {rec['decoded']}")
        fwd = rec["launches"]["flash_attn_fwd"]
        if not rec["encoder_calls"] or \
                fwd != TURBO["encoder_layers"] * rec["encoder_calls"]:
            raise AssertionError(f"[sharded eval] rank {rank}: flash fwd "
                                 f"{fwd}, {rec['encoder_calls']} encoder "
                                 "calls")
        if rec["metrics"] != ref_metrics:
            raise AssertionError(f"[sharded eval] rank {rank} metrics "
                                 f"{rec['metrics']} != one process's "
                                 f"{ref_metrics}")
    hyps = sorted((out / f"test_{name}").rglob("tcp_wer_hyp.json"))
    base = work / "exp"
    if [h.relative_to(out) for h in hyps] != \
            [h.relative_to(base) for h in single["hyps"]]:
        raise AssertionError(f"[sharded eval] hypothesis files {hyps}")
    for a, b in zip(hyps, single["hyps"]):
        if json.loads(a.read_text()) != json.loads(b.read_text()):
            raise AssertionError(f"[sharded eval] {a} differs from {b}")
    csvs = list(out.rglob("all_session_wer.csv"))
    if len(csvs) != 1:
        raise AssertionError(f"[sharded eval] session CSVs {csvs}")
    fwd = [rec["launches"]["flash_attn_fwd"] for rec in recs]
    log(f"[sharded eval] rank 0 decoded batches {recs[0]['decoded']}, rank 1 "
        f"{recs[1]['decoded']}; flash fwd {fwd[0]} / {fwd[1]}; "
        f"{len(hyps)} hypothesis "
        f"files and the metrics equal one process's at batch 4; decode and "
        f"scoring {recs[0]['eval']:.1f} / {recs[1]['eval']:.1f} s a rank "
        f"({single['wall']:.1f} s in one process); the CLI's wall "
        f"{recs[0]['wall']:.1f} / {recs[1]['wall']:.1f} s a rank")
    shutil.rmtree(work, ignore_errors=True)
    return {"dicow_v3_greedy_b4": single["launches"],
            "dicow_v3_greedy_sharded_2ranks": _summed(recs)}


# -- the device-time gate and phase 27: the tools as child processes


def flash_trace_line(tag: str, trace: dict, reps: int) -> str:
    """What a trace of ``reps`` flash forwards caught, kernel by kernel:
    records, device ms per record, records of zero duration; and the
    launches whose device records it lost."""
    rows = ", ".join(f"{name.split('(')[0][-40:]} {n} x "
                     f"{us / max(n, 1) / 1e3:.4f} ms ({zero} zero)"
                     for name, (n, us, zero) in trace["kernels"].items())
    return (f"[devicetime] {tag}: {reps} calls, {rows or 'no records'}; "
            f"{trace['launches']} launches, {trace['unmatched']} without "
            f"their device record ({trace['lost_in_lead']} lost in the "
            f"lead); {trace['us'] / 1e3 / reps:.4f} ms a call as caught; "
            f"streams {trace['streams']}, devices {trace['devices']}, a "
            f"profiler already on: {trace['profiler_was_on']}")


def flash_main_reading(dev, reps: int = 20) -> tuple:
    """The flash forward at ENC_SHAPE bf16: its device time per call
    (utils/devicetime.py), a trace of ``reps`` calls after the reading's
    lead of 256 absorbing launches (what it sums), and a trace with no
    lead (what a sum of a whole trace catches)."""
    from ts_asr_whisper_tpu_torch.ops import attention as A

    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(ENC_SHAPE, device=dev, generator=gen) * s
               for s in (0.125, 1.0, 1.0))
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))

    def fn():
        return A.flash_mha_fwd(q, k, v)

    return (measure_device_ms(fn, reps=reps), kernel_trace(fn, reps, 256),
            kernel_trace(fn, reps))


def phase_devicetime_gate(dev, early: tuple, process_s: float) -> dict:
    """After the last training phase of this process: the flash forward's
    device time at the main shape again, against phase 3's reading; fails
    when the two are more than DEVICE_TIME_GATE apart. Prints what each
    trace caught, with a lead and without one."""
    late = flash_main_reading(dev)
    ms0, ms1 = early[0], late[0]
    log(f"[devicetime] flash forward {ENC_SHAPE} bf16 device time: phase 3 "
        f"{fmt_ms(ms0)}, after the last training phase {fmt_ms(ms1)} "
        f"(process {process_s:.0f} s old; gate {DEVICE_TIME_GATE}x)")
    for when, (_, led, bare) in (("phase 3", early), ("after training",
                                                      late)):
        log(flash_trace_line(f"{when}, after a lead of 256", led, 20))
        log(flash_trace_line(f"{when}, no lead", bare, 20))
    if ms0 is None or ms1 is None or \
            max(ms0 / ms1, ms1 / ms0) > DEVICE_TIME_GATE:
        raise AssertionError(f"devicetime: {fmt_ms(ms0)} in phase 3 against "
                             f"{fmt_ms(ms1)} after training")
    return {"device_ms_phase3": ms0, "device_ms_after_training": ms1}


def start_tool(module: str, args: list) -> tuple:
    """``python -m ts_asr_whisper_tpu_torch.scripts.<module> <args>`` in a
    child process of its own session; returns (process, command, start)."""
    cmd = [sys.executable, "-m", f"ts_asr_whisper_tpu_torch.scripts.{module}",
           *map(str, args)]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return (subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True,
                             start_new_session=True),
            cmd, time.perf_counter())


def finish_tool(tag: str, started: tuple) -> dict:
    """Wait for a tool started by ``start_tool`` (killed at TOOL_TIMEOUT)
    and put its output in this log. Fails on a non-zero exit. Returns its
    stdout, stderr and the kernel launches it printed (all 0 when it
    printed none)."""
    from ts_asr_whisper_tpu_torch import kernels

    proc, cmd, t0 = started
    try:
        out, err = proc.communicate(timeout=TOOL_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        err += f"\ntimed out after {TOOL_TIMEOUT} s"
    (WORK / "tools").mkdir(parents=True, exist_ok=True)
    (WORK / "tools" / f"{tag}.log").write_text(out + "\n" + err)
    for line in out.splitlines():
        log(f"[{tag}] {line}")
    log(f"[{tag}] exit {proc.returncode}, {time.perf_counter() - t0:.1f} s")
    if proc.returncode != 0:
        raise AssertionError(f"[{tag}] {' '.join(cmd)} exited "
                             f"{proc.returncode}:\n{err[-4000:]}")
    launches = dict.fromkeys(kernels.launch_counts, 0)
    for line in out.splitlines():
        if line.startswith("kernel launches: "):
            launches = json.loads(line[len("kernel launches: "):])
    return {"out": out, "err": err, "launches": launches}


def run_tool(tag: str, module: str, args: list) -> dict:
    return finish_tool(tag, start_tool(module, args))


def start_export(dev) -> dict:
    """Phase 27's first tool, started early: a checkpoint of the turbo
    width at DP_LAYERS encoder layers written with
    save_model_checkpoint, and export_dicow of it in a child process
    on the CPU, which runs while phase 28's ranks and the next tools run
    (``phase_tools`` waits for it)."""
    from ts_asr_whisper_tpu_torch.config import load_config
    from ts_asr_whisper_tpu_torch.models.containers import WhisperContainer
    from ts_asr_whisper_tpu_torch.training.checkpoints import \
        save_model_checkpoint

    gc.collect()
    torch.cuda.empty_cache()
    work = WORK / "tools"
    shutil.rmtree(work, ignore_errors=True)
    # at DP_LAYERS encoder layers: the checkpoint and its export
    # are written to disk, whose writes the machine bounds
    model_dir = work / "model"
    model_dir.mkdir(parents=True)
    (model_dir / "config.json").write_text(json.dumps(
        {**TURBO, "encoder_layers": DP_LAYERS}))
    overrides = [f"model.whisper_model={model_dir}", "model.ctc_weight=0.3"]
    container = WhisperContainer(load_config(overrides), dev, seed=11)
    saved = {k: v.detach().cpu().clone()
             for k, v in container.model.state_dict().items()}
    save_model_checkpoint(str(work / "ckpt"), container.model, step=7)
    del container
    gc.collect()
    torch.cuda.empty_cache()
    export = work / "export"
    return {"work": work, "saved": saved, "export": export,
            "started": start_tool("export_dicow",
                                  ["--ckpt", work / "ckpt", "--out", export,
                                   *overrides])}


def phase_tools(dev, exporting: dict) -> dict:
    """Phase 27: the device tools of ts_asr_whisper_tpu_torch/scripts as
    child processes at full turbo width, each of which must exit 0:
    export_dicow (``start_export``'s; the export loads strictly into the
    port's container and every tensor equals the saved model's),
    cuda_kernel_check (all six kernels matched), probe_psi_gather
    (--quick), probe_train_batch at micro-batches 4 and 8, smoke_decode of
    the export on phase 7's recordings (scored by the native tcpWER
    library), and profile_decode at --max-new 32 and with --reorder pallas
    (every stage with its device ms). Returns each tool's kernel
    launches."""
    import re

    from ts_asr_whisper_tpu_torch.config import load_config
    from ts_asr_whisper_tpu_torch.data.synthetic import write_corpus
    from ts_asr_whisper_tpu_torch.models.containers import WhisperContainer

    gc.collect()
    torch.cuda.empty_cache()
    work, saved, export = (exporting[k] for k in ("work", "saved", "export"))
    t_phase = time.perf_counter()
    paths = {}

    res = run_tool("cuda_kernel_check", "cuda_kernel_check", [])
    if "OK: all six CUDA kernels match" not in res["out"] or not all(
            res["launches"][k] for k in PORTED):
        raise AssertionError(f"cuda_kernel_check: {res['launches']}")
    paths["tool:cuda_kernel_check"] = res["launches"]

    res = run_tool("probe_psi_gather", "probe_psi_gather", ["--quick"])
    if not res["launches"]["psi_gather_dot"]:
        raise AssertionError("probe_psi_gather launched no psi kernel")
    paths["tool:probe_psi_gather"] = res["launches"]

    res = run_tool("probe_train_batch", "probe_train_batch",
                   ["--batches", 4, 8])
    recs = [json.loads(x) for x in res["out"].splitlines()
            if x.startswith("{")]
    if [r["batch"] for r in recs] != [4, 8] or not recs[0]["ok"] or \
            not res["launches"]["flash_attn_bwd"]:
        raise AssertionError(f"probe_train_batch: {recs}")
    paths["tool:probe_train_batch"] = res["launches"]

    res = finish_tool("export_dicow", exporting["started"])
    if f"Exported step 7 to {export}" not in res["out"]:
        raise AssertionError("export_dicow: no export line")
    paths["tool:export_dicow"] = res["launches"]
    # a strict load: the export holds exactly the container's tensors
    loaded = WhisperContainer(load_config([f"model.whisper_model={export}",
                                           "model.ctc_weight=0.3"]), dev)
    got = loaded.model.state_dict()
    bad = [k for k, v in saved.items()
           if not torch.equal(got[k].detach().cpu(), v)]
    log(f"[export_dicow] loaded strictly into the port's container, "
        f"{len(saved) - len(bad)} of {len(saved)} tensors equal to the "
        "saved model's")
    if bad:
        raise AssertionError(f"export_dicow: {bad[:5]} differ")
    del loaded, got, saved
    gc.collect()
    torch.cuda.empty_cache()

    manifest = write_corpus(work / "corpus", [60.0] * 8, seed=0)
    res = run_tool("smoke_decode", "smoke_decode",
                   ["--model-dir", export, "--cutset", manifest,
                    "--output-dir", work / "smoke", "--batch", 16,
                    "--max-length", 128, "--dtype", "bfloat16"])
    final = json.loads(res["out"].splitlines()[-1])
    tcp = [v for k, v in final.items() if k.endswith("tcp_wer")]
    if not tcp or not all(map(math.isfinite, tcp)) \
            or "scoring=native" not in res["err"] \
            or not res["launches"]["flash_attn_fwd"]:
        raise AssertionError(f"smoke_decode: {final}, scoring line "
                             f"{'scoring=native' in res['err']}")
    log(f"[smoke_decode] tcpWER {tcp[0]} scored by the native library")
    paths["tool:smoke_decode"] = res["launches"]

    for tag, args in (("profile_decode", []),
                      ("profile_decode_reorder_pallas",
                       ["--reorder", "pallas"])):
        res = run_tool(tag, "profile_decode", ["--max-new", 32, *args])
        lines = res["out"].splitlines()
        for stage in DECODE_STAGES:
            hit = [x for x in lines if stage in x]
            if not hit or not re.search(r"device +[\d.]+ ms", hit[0]):
                raise AssertionError(f"{tag}: no device reading for "
                                     f"{stage!r}")
        want = ("kv_reorder_bhtd" if args else "ancestry_attn",
                "flash_attn_fwd", "psi_gather_dot")
        if not all(res["launches"][k] for k in want):
            raise AssertionError(f"{tag}: launches {res['launches']}")
        paths[f"tool:{tag}"] = res["launches"]
    log(f"[tools] phase 27: {time.perf_counter() - t_phase:.1f} s")
    shutil.rmtree(work, ignore_errors=True)
    return paths


def main() -> int:
    t_start = time.perf_counter()
    kind = phase_card()
    dev = torch.device("cuda", 0)
    phase_build()
    k_flash = phase_kernel(dev)
    early = (k_flash["device_ms"], *flash_main_reading(dev)[1:])
    k_bwd = phase_flash_bwd(dev)
    k_anc = phase_ancestry(dev)
    k_psi = phase_psi(dev)
    k_reorder = phase_reorder(dev)
    k_optim = phase_optimizer(dev)
    phase_encoder(dev)
    phase_mel_topk(dev)
    mark(t_start, "phases 1-6 and 19")
    paths = {"dicow_v3_greedy": phase_decode(dev),
             "dicow_v3_beam_joint": phase_beam_decode(dev)["launches"],
             "dicow_v3_train": phase_train(dev)["launches"],
             "se_dicow_beam_joint": phase_se_dicow(
                 dev, "bhtd", [60.0] * 2)["launches"],
             "se_dicow_beam_joint_tbhd": phase_se_dicow(
                 dev, "tbhd", [60.0])["launches"],
             "se_dicow_train": phase_se_dicow_train(dev)["launches"],
             "pretrain": phase_pretrain(dev)["launches"]}
    remat = phase_remat(dev)
    paths.update({f"dicow_v3_remat_{p}": r["launches"]
                  for p, r in remat.items()})
    paths["dicow_v3_lora"] = phase_lora(dev)["launches"]
    paths["dicow_v3_beam_joint_fallback_int8"] = phase_fallback_int8(
        dev)["launches"]
    paths["dicow_v3_greedy_token_ts"] = phase_token_ts(dev)["launches"]
    mark(t_start, "phases 7-18")
    ctx = dp_setup(dev)
    paths.update(phase_dp_train(ctx))
    mark(t_start, "phases 20-21")
    paths.update(phase_tp_train(ctx, phase_sharded_eval(dev)))
    mark(t_start, "phases 22-23")
    paths.update(phase_tp_se_dicow(dev))
    mark(t_start, "phase 24")
    paths.update(phase_lora_fsdp(ctx, autobatch_job(ctx)))
    mark(t_start, "phases 25-26")
    exporting = start_export(dev)  # phase 27's export, on the CPU
    paths.update(phase_autobatch_sharded(ctx))
    mark(t_start, "phase 28")
    shutil.rmtree(ctx.pop("work"), ignore_errors=True)
    phase_devicetime_gate(dev, early, time.perf_counter() - t_start)
    paths.update(phase_tools(dev, exporting))
    mark(t_start, "phase 27")
    from ts_asr_whisper_tpu_torch.kernels import KERNEL_SOURCES

    csrc = "ts_asr_whisper_tpu_torch/kernels/csrc"
    replaces = {"flash_attn_fwd": "ts_asr_whisper_tpu/ops/attention.py:84",
                "flash_attn_bwd": "ts_asr_whisper_tpu/ops/attention.py:178",
                "ancestry_attn": "ts_asr_whisper_tpu/ops/beam_attention.py:110",
                "psi_gather_dot": "ts_asr_whisper_tpu/ops/psi_gather.py:125",
                "kv_reorder_bhtd": "ts_asr_whisper_tpu/ops/reorder.py:36",
                "kv_reorder_tbhd": "ts_asr_whisper_tpu/ops/reorder.py:64",
                # on the TPU XLA fused optax's clip and update
                "adamw_multi": "none", "sq_norm_multi": "none"}
    timing = {"flash_attn_fwd": k_flash, "flash_attn_bwd": k_bwd,
              "ancestry_attn": k_anc, "psi_gather_dot": k_psi, **k_reorder,
              **k_optim}
    record = {"kernels": [{
        "name": name, "route": "cuda",
        "source": f"{csrc}/{KERNEL_SOURCES[name]}.cu",
        "replaces": replaces[name],
        # the tools' launches (phase 27) are listed by path, not counted:
        # cuda_kernel_check's are comparisons with the plain versions
        "launches": sum(launches[name] for path, launches in paths.items()
                        if not path.startswith("tool:")),
        "launches_by_path": {path: launches[name]
                             for path, launches in paths.items()},
        **timing[name]} for name in KERNELS]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(child(sys.argv[2]) if sys.argv[1:2] == ["--child"] else main())
