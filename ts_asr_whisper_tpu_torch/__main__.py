"""CLI of the port: ``python -m ts_asr_whisper_tpu_torch <overrides>``.

Takes the JAX CLI's config groups and overrides (``+decode=dicow_v3_greedy``,
dotted ``key=value``; see ts_asr_whisper_tpu/config.py) and runs a
decode-only job on one device: the GPU when there is one, else the CPU.
Training and pre-training are not ported yet.
"""

from __future__ import annotations

import sys

from ts_asr_whisper_tpu.utils.logging_def import get_logger

logger = get_logger("ts_asr_whisper_tpu_torch")


def main(argv=None):
    from .decode import load_decode_config, main as decode_main

    cfg = load_decode_config(sys.argv[1:] if argv is None else argv)
    logger.info("experiment=%s output_dir=%s", cfg.experiment,
                cfg.training.output_dir)
    return decode_main(cfg)


if __name__ == "__main__":
    out = main()
    if out:
        logger.info("final metrics: %s", out)
