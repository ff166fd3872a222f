"""CLI of the port:
``python -m ts_asr_whisper_tpu_torch [--device {cuda,cuda:N,cpu}]
[--backend B] <overrides>``, or over several ranks
``torchrun --nproc-per-node N -m ts_asr_whisper_tpu_torch ...``.

Takes the JAX CLI's config groups and overrides (``+decode=dicow_v3_greedy``,
``+train=dicow_v3``, dotted ``key=value``; see config.py) and runs on the
GPU unless ``--device cpu`` asks for the CPU. Without a CUDA device and
without ``--device cpu`` it refuses to run. ``decode_only=true`` decodes and
scores; otherwise it fine-tunes (train.py).

Under torchrun every rank joins the process group first (parallel/dist.py,
as the JAX CLI calls ``dist_init`` first), then loads the config for a mesh
of ``WORLD_SIZE`` devices, so ``overall_batch_size`` is divided over the
ranks. ``--device cuda`` is the rank's own card, ``cuda:LOCAL_RANK``;
``cuda:N`` puts every rank on card N (ranks that share a card need
``--backend gloo``: NCCL refuses two ranks on one device). The backend
defaults to gloo for CPU tensors and NCCL for CUDA tensors, or gloo alone
with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys

import torch

from .parallel import dist as pdist
from .utils.logging_def import get_logger

logger = get_logger("ts_asr_whisper_tpu_torch")


def resolve_device(name: str) -> torch.device:
    """``cpu``; ``cuda`` (this rank's card, ``cuda:LOCAL_RANK``) or
    ``cuda:N``, made the current CUDA device."""
    if name == "cpu":
        return torch.device("cpu")
    if not name.startswith("cuda") or not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the port runs on the GPU; pass "
                         "--device cpu to run on the CPU")
    device = torch.device(name)
    if device.index is None:
        device = torch.device("cuda", pdist.local_rank())
    if device.index >= torch.cuda.device_count():
        raise SystemExit(f"rank {pdist.get_rank()} asks for {device}: this "
                         f"host has {torch.cuda.device_count()} CUDA devices")
    torch.cuda.set_device(device)
    return device


def main(argv=None):
    from .config import load_config

    parser = argparse.ArgumentParser(prog="python -m ts_asr_whisper_tpu_torch")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default: under torchrun the rank's "
                             "card), cuda:N or cpu")
    parser.add_argument("--backend", default=None,
                        help="torch.distributed backend under torchrun "
                             f"(default {pdist.DEFAULT_BACKEND!r}; 'gloo' "
                             "with --device cpu)")
    parser.add_argument("overrides", nargs="*",
                        help="+group=name config groups and dotted "
                             "key=value overrides")
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    device = resolve_device(args.device)
    pdist.initialize(args.backend or ("gloo" if device.type == "cpu"
                                      else pdist.DEFAULT_BACKEND))
    cfg = load_config(args.overrides, n_devices=pdist.world_size())
    logger.info("experiment=%s output_dir=%s device=%s rank=%d/%d",
                cfg.experiment, cfg.training.output_dir, device,
                pdist.get_rank(), pdist.world_size())
    if cfg.training.pretrain_encoder:
        from .pretrain_encoder import main as run
    elif cfg.training.decode_only:
        from .decode import main as run
    else:
        from .train import main as run
    try:
        return run(cfg, device)
    finally:
        pdist.finalize()


if __name__ == "__main__":
    out = main()
    if out:
        logger.info("final metrics: %s", out)
