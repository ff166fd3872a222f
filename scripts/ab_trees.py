#!/usr/bin/env python
"""A/B of checkouts of the repository on one NVIDIA GPU, end to end,
through each checkout's own ``chip_smoke.py`` phases.

    python3 scripts/ab_trees.py [--phases encoder,train] <checkout> ...

Runs each checkout in a process of its own, in the order given (give the
parent and the change in turns: parent, change, change, parent), and for
each prints its build and the chosen phases as that checkout's
``chip_smoke.py`` logs them:
  encoder  phase 6, the large-v3-turbo DiCoW encoder: fp32 on 2 windows,
           then bf16 on 16 windows through the flash kernel and through
           plain attention;
  train    phase 9, ``+train=dicow_v3``: 8 micro-batches of 4 with the
           trainer's per-step times;
  greedy   phase 7, long-form greedy decode of 16 rows, then the greedy
           loop alone (ms per step).
Then one JSON line per checkout with the encoder's ms per 16 windows, the
per-micro-batch seconds, the greedy decode's audio-s/s and the loop's ms
per step.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

RUN = """
import sys, torch
sys.path.insert(0, {root!r})
import chip_smoke as c
c.phase_card()
c.phase_build()
dev = torch.device("cuda", 0)
for phase in {phases!r}:
    {{"encoder": c.phase_encoder, "train": c.phase_train,
     "greedy": c.phase_decode}}[phase](dev)
"""
PHASES = ("encoder", "train", "greedy")


def main() -> int:
    args = sys.argv[1:]
    phases = ["encoder", "train"]
    if args[:1] == ["--phases"]:
        phases, args = args[1].split(","), args[2:]
    trees = [Path(p).resolve() for p in args]
    if not trees or not set(phases) <= set(PHASES):
        print(__doc__)
        return 2
    for tree in trees:
        proc = subprocess.run(
            [sys.executable, "-c", RUN.format(root=str(tree), phases=phases)],
            cwd=tree, capture_output=True, text=True)
        out = proc.stdout + proc.stderr
        keep = [line for line in out.splitlines()
                if line.startswith(("[encoder]", "[train] 8", "[build] 5",
                                    "[greedy] 16", "[decode]"))
                or "s/1 steps" in line]
        print(f"=== {tree} (exit {proc.returncode})")
        print("\n".join(keep))
        enc = re.search(r"16 windows: kernel ([0-9.]+) ms", out)
        steps = [float(x) for x in re.findall(r"\(([0-9.]+) s/1 steps\)", out)]
        greedy = re.search(r"([0-9.]+) audio-s/s", out)
        loop = re.search(r"([0-9.]+) ms/step", out)
        print(json.dumps({"tree": str(tree), "exit": proc.returncode,
                          "encoder_ms_16_windows": enc and float(enc.group(1)),
                          "micro_batch_s": steps,
                          "greedy_audio_s_per_s": greedy
                          and float(greedy.group(1)),
                          "greedy_loop_ms_per_step": loop
                          and float(loop.group(1))}))
        if proc.returncode != 0:
            print(out[-3000:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
