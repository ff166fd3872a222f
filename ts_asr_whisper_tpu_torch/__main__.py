"""CLI of the port:
``python -m ts_asr_whisper_tpu_torch [--device {cuda,cpu}] <overrides>``.

Takes the JAX CLI's config groups and overrides (``+decode=dicow_v3_greedy``,
``+train=dicow_v3``, dotted ``key=value``; see config.py) and runs on one
device: the GPU unless ``--device cpu`` asks for the CPU. Without a CUDA
device and without ``--device cpu`` it refuses to run. ``decode_only=true``
decodes and scores; otherwise it fine-tunes (train.py).
"""

from __future__ import annotations

import argparse
import sys

import torch

from .utils.logging_def import get_logger

logger = get_logger("ts_asr_whisper_tpu_torch")


def resolve_device(name: str) -> torch.device:
    if name == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the port runs on the GPU; pass "
                         "--device cpu to run on the CPU")
    return torch.device(name)


def main(argv=None):
    from .config import load_config

    parser = argparse.ArgumentParser(prog="python -m ts_asr_whisper_tpu_torch")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where to run (default cuda)")
    parser.add_argument("overrides", nargs="*",
                        help="+group=name config groups and dotted "
                             "key=value overrides")
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    device = resolve_device(args.device)
    cfg = load_config(args.overrides)  # one device
    logger.info("experiment=%s output_dir=%s device=%s", cfg.experiment,
                cfg.training.output_dir, device)
    if cfg.training.pretrain_encoder:
        from .pretrain_encoder import main as run
    elif cfg.training.decode_only:
        from .decode import main as run
    else:
        from .train import main as run
    return run(cfg, device)


if __name__ == "__main__":
    out = main()
    if out:
        logger.info("final metrics: %s", out)
