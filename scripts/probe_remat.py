#!/usr/bin/env python
"""The remat policies of the PyTorch port's fine-tune on one NVIDIA GPU:
where the time of 'full', 'dots' and 'attn' goes, at large-v3-turbo width.

    python3 scripts/probe_remat.py [--micro-batches 4 8 12]

The dicow_v3 fine-tune's base phase (decoder frozen, bf16 compute, fp32
parameters, random weights, random 30 s features, 64 label tokens) runs
forward + backward without checkpointing ('off'), under each policy, and
under 'sac_none': selective checkpointing whose policy saves nothing, the
same work as 'full' through the dispatch mode that 'dots' needs, so its
time over 'full' is that mode's cost ('attn' needs no such mode: it splits
each encoder layer around its attention core,
models/dicow.py::DiCoWEncoder._remat_layer). For each micro-batch size the
variants run in two rounds, the second in reverse order (host-bound times
drift); each is warmed up by one micro-batch, then timed over 3 (host
clock around work that ends in a synchronize), its device time summed
from a torch.profiler trace of one, its peak memory read. The last line is
one JSON object with every number.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import time
from functools import partial
from pathlib import Path

sys.modules["jax"] = None  # the port never reaches jax
sys.modules["ts_asr_whisper_tpu"] = None
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402
from torch.utils import checkpoint as ckpt  # noqa: E402

import chip_smoke as c  # noqa: E402

VARIANTS = ("off", "full", "sac_none", "dots", "attn")


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--micro-batches", type=int, nargs="+",
                        default=[4, 8, 12])
    args = parser.parse_args()
    kind = c.phase_card()
    dev = torch.device("cuda", 0)
    from ts_asr_whisper_tpu_torch import kernels
    from ts_asr_whisper_tpu_torch.config import load_config
    from ts_asr_whisper_tpu_torch.models import dicow as D
    from ts_asr_whisper_tpu_torch.models import whisper as W
    from ts_asr_whisper_tpu_torch.models.containers import WhisperContainer
    from ts_asr_whisper_tpu_torch.training.optim import param_labels
    from ts_asr_whisper_tpu_torch.training.trainer import loss_fn

    kernels.build_all(["flash_attn_fwd", "flash_attn_bwd"])
    remat_context = W.remat_context

    def with_sac_none(policy: str):
        """remat_context and one more policy, 'sac_none'."""
        if policy == "sac_none":
            return partial(
                ckpt.create_selective_checkpoint_contexts,
                lambda *a, **k: ckpt.CheckpointPolicy.PREFER_RECOMPUTE)
        return remat_context(policy)

    D.remat_context = W.remat_context = with_sac_none
    work = c.WORK / "probe_remat"
    shutil.rmtree(work, ignore_errors=True)
    cfg = load_config(["+train=dicow_v3",
                       f"model.whisper_model={c._turbo_dir(work)}",
                       "model.reinit_encoder_from=null",
                       "data.train_cutsets=[]", "data.dev_cutsets=[]",
                       "data.eval_cutsets=[]", "data.dataset_weights=null",
                       "aug.musan_root=null"])
    container = WhisperContainer(cfg, dev, seed=0)
    model, mc = container.model, container.model_config
    labels = param_labels(model, cfg.model.prefixes_to_preheat,
                          cfg.model.params_to_keep_frozen_keywords, False)
    for name, p in model.named_parameters():
        p.requires_grad_(labels[name] != "frozen")
    model.train()
    trainable = [p for p in model.parameters() if p.requires_grad]
    gen = torch.Generator(device=dev).manual_seed(0)

    def batch(b):
        stno = torch.nn.functional.one_hot(torch.randint(
            0, 4, (b, 1500), device=dev, generator=gen), 4)
        labels = torch.randint(0, 50000, (b, 64), device=dev, generator=gen)
        labels[:, :3] = torch.tensor(container.tokenizer.prefix_tokens[:3])
        return {"input_features": torch.randn(b, 128, 3000, device=dev,
                                              generator=gen),
                "stno_mask": stno.transpose(1, 2).float(), "labels": labels,
                "upp_labels": labels}

    def run(variant, batches):
        remat = None if variant == "off" else variant
        model.encoder.remat = model.decoder.remat = remat
        for p in trainable:
            p.grad = None
        for b in batches:
            loss_fn(model, mc, b, 3)[0].backward()

    record = {"card": kind, "micro_batches": {}}
    for mb in args.micro_batches:
        batches = [batch(mb) for _ in range(3)]
        res = {v: {"ms_rounds": []} for v in VARIANTS}
        for v in VARIANTS + VARIANTS[::-1]:
            run(v, batches[:1])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            run(v, batches)
            torch.cuda.synchronize()
            res[v]["ms_rounds"].append((time.perf_counter() - t0) * 1e3 / 3)
            res[v]["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            if "device_ms" not in res[v]:
                res[v]["device_ms"] = c.device_ms(
                    lambda: run(v, batches[:1]), reps=1)
        for v, r in res.items():
            c.log(f"[probe_remat] micro-batch {mb} {v}: "
                  f"{' / '.join(f'{x:.0f}' for x in r['ms_rounds'])} ms "
                  f"per micro-batch, device {c.fmt_ms(r['device_ms'])}, "
                  f"peak {r['peak_gib']:.1f} GiB")
        record["micro_batches"][mb] = res
        del batches
        torch.cuda.empty_cache()
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
