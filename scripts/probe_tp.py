#!/usr/bin/env python
"""chip_smoke.py's tensor-parallel phases alone, on one NVIDIA GPU:

    python3 scripts/probe_tp.py

Builds the two flash kernels, runs phase 20's two unwrapped dicow_v3
fine-tunes at large-v3-turbo width (the reference and the loss tolerance),
then phase 23 (the fine-tune on a mesh [1, 2], two ranks sharing the card
over gloo through torchrun and the CLI, beside phase 22's sharded decode)
and phase 24 (SE-DiCoW at 4
encoder layers and 2 SCBs on a mesh [2, 2], four ranks); see
chip_smoke.py's docstring. Prints what those phases print and, last, the
launch counts of each path as one JSON object.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as C  # noqa: E402  (blocks jax and the JAX package)


def main() -> int:
    C.phase_card()
    dev = C.torch.device("cuda", 0)
    from ts_asr_whisper_tpu_torch import kernels

    kernels.build_all(["flash_attn_fwd", "flash_attn_bwd"])
    ctx = C.dp_setup(dev)
    paths = C.phase_tp_train(ctx, C.phase_sharded_eval(dev))
    paths.update(C.phase_tp_se_dicow(dev))
    print(json.dumps(paths))
    return 0


if __name__ == "__main__":
    sys.exit(main())
