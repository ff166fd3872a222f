#!/usr/bin/env python
"""chip_smoke.py's phase 28 (auto_find_batch_size under FSDP2 and the
``model`` axis) alone, on one NVIDIA GPU:

    python3 scripts/probe_autobatch_sharded.py [--measure 26|28] [--phase21]

Prints the torch release's FSDP2 custom-comm interface (the two setters,
their signatures, and the lines of FSDP2's collectives that call a comm),
builds the two flash kernels, sets up phase 20's corpus, then:

- by default, phase 28 as chip_smoke.py runs it (its caps, its checks);
- with ``--measure 28``, phase 28's two launches uncapped from
  micro-batch 4 and again from micro-batch 2, side by side each time;
  with ``--measure 26``, phase 26's launch so, alone: every rank's probe
  and training-loop peaks at both sizes, from which the caps of
  AUTOBATCH_SHARDED and AUTOBATCH_CAP_GIB are taken;
- with ``--phase21``, first phase 21 (two DDP ranks over gloo) against
  the runs split as its ranks split each micro-batch (phase 20's
  reference runs are made for it).

Prints what those phases print and, last, the launch counts of each path
as one JSON object.
"""

from __future__ import annotations

import argparse
import inspect
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as C  # noqa: E402  (blocks jax and the JAX package)


def comm_interface() -> None:
    """The FSDP2 custom-comm setters of this torch and how its collectives
    call a comm."""
    import torch
    from torch.distributed.fsdp import FSDPModule
    from torch.distributed.fsdp._fully_shard import _fsdp_collectives

    C.log(f"[comm] torch {torch.__version__}")
    for name in ("set_custom_all_gather", "set_custom_reduce_scatter"):
        fn = getattr(FSDPModule, name, None)
        C.log(f"[comm] FSDPModule.{name}: "
              + (str(inspect.signature(fn)) if fn else "absent"))
    for name in ("foreach_all_gather", "foreach_reduce"):
        lines = inspect.getsource(getattr(_fsdp_collectives, name))
        C.log(f"[comm] {name}: " + " | ".join(
            x.strip() for x in lines.splitlines()
            if "comm" in x and ("(" in x or "=" in x)))


def measure(ctx: dict, phase: str) -> dict:
    """The launches of ``phase`` uncapped from micro-batch 4, then 2."""
    total = C.torch.cuda.get_device_properties(0).total_memory / 2**30
    paths = {}
    for micro in (4, 2):
        jobs = (C.autobatch_sharded_jobs(ctx, micro=micro, capped=False)
                if phase == "28"
                else [C.autobatch_job(ctx, micro=micro, capped=False)["job"]])
        for job in jobs:
            job["tag"] = f"{job['tag']}_from_{micro}"
        for job, recs in zip(jobs, C.run_ranks_together(*jobs)):
            C._probe_lines(job["tag"], recs, total)
            C.log(f"[{job['tag']}] training loop at micro-batch "
                  f"{recs[0]['micro_batch']}: peak "
                  + " / ".join(f"{r['peak']:.2f}" for r in recs)
                  + " GiB; losses "
                  + str([round(r["loss"], 6) for r in recs[0]["logged"]]))
            paths[job["tag"]] = C._summed(recs)
    return paths


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--measure", choices=("26", "28"))
    ap.add_argument("--phase21", action="store_true")
    args = ap.parse_args()
    C.phase_card()
    comm_interface()
    dev = C.torch.device("cuda", 0)
    from ts_asr_whisper_tpu_torch import kernels

    kernels.build_all(["flash_attn_fwd", "flash_attn_bwd"])
    ctx = C.dp_setup(dev) if args.phase21 else C.dp_context(dev)
    paths = C.phase_dp_train(ctx) if args.phase21 else {}
    if args.measure:
        paths.update(measure(ctx, args.measure))
    else:
        paths.update(C.phase_autobatch_sharded(ctx))
    print(json.dumps(paths))
    return 0


if __name__ == "__main__":
    sys.exit(main())
