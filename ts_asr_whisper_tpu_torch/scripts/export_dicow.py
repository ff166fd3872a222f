"""Export a trained checkpoint to the HF DiCoW layout
(reference utils/export_dicow.py, minus the hub push).

Counterpart of scripts/export_dicow.py over the port's
training/checkpoints.py:

    python -m ts_asr_whisper_tpu_torch.scripts.export_dicow \
        --ckpt <output_dir>/ckpt --out <dir> [overrides]

The overrides name the model as the CLI's do (``model.whisper_model=...``,
``model.ctc_weight=...``). The checkpoint's state dict loads strictly into
the port's container, built on the CPU (the export moves no tensor to a
card), and is written as ``model.safetensors`` + ``config.json``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..config import load_config
from ..models.containers import WhisperContainer
from ..training.checkpoints import export_hf_checkpoint, restore_checkpoint


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", type=Path, required=True,
                    help="checkpoint dir (output_dir/ckpt: step_<n>/, "
                         "latest)")
    ap.add_argument("--out", type=Path, required=True)
    ap.add_argument("overrides", nargs="*", default=[])
    args = ap.parse_args(argv)

    cfg = load_config(list(args.overrides))
    container = WhisperContainer(cfg, "cpu")
    state, step = restore_checkpoint(str(args.ckpt))
    container.model.load_state_dict(state["params"], strict=True)
    export_hf_checkpoint(container.model.state_dict(),
                         container.model_config, str(args.out))
    print(f"Exported step {step} to {args.out}")


if __name__ == "__main__":
    main()
