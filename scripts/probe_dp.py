#!/usr/bin/env python
"""chip_smoke.py's data-parallel phases alone, on one NVIDIA GPU:

    python3 scripts/probe_dp.py

Builds the two flash kernels, runs phase 9 (the dicow_v3 fine-tune at
large-v3-turbo width, through ModelTrainer), then phases 20-22: the
fine-tune through the CLI under torchrun on one rank over NCCL with DDP
and with FSDP2 and, beside them, on two ranks that share the card over
gloo, and the rank-sharded greedy decode (see chip_smoke.py's docstring). Prints
what those phases print and, last, the launch counts of each path as one
JSON object.
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
    paths = {"dicow_v3_train": C.phase_train(dev)["launches"],
             **C.phase_dp_train(C.dp_setup(dev))}
    sharded = C.phase_sharded_eval(dev)
    paths.update(sharded["check"](C.run_ranks_together(sharded["job"])[0]))
    print(json.dumps(paths))
    return 0


if __name__ == "__main__":
    sys.exit(main())
