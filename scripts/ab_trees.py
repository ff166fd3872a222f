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
           loop alone (ms per step);
  beam     phase 8, dicow_v3_beam_joint (batch 2 x 5 beams, 8 rows) on the
           ancestry cache: ms per beam step and audio-s/s;
  se_dicow phase 10, se_dicow_beam_joint (4 rows, the 'bhtd' cache with the
           standalone permute): ms per beam step and audio-s/s;
  ancestry phase 4, the ancestry kernel: per call (CUDA events, wrapper
           included) and device time at Bb 10, H 20, T 448, pos 224 bf16;
  psi      phase 5, the psi kernel: the same at P (2, 51867, 375) fp32.
Then one JSON line per checkout with the encoder's ms per 16 windows, the
per-micro-batch seconds, each decode's audio-s/s, the greedy loop's ms per
step, the beam decodes' ms per beam step and the two beam kernels' ms per
call and device ms.
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
     "greedy": c.phase_decode, "beam": c.phase_beam_decode,
     "se_dicow": lambda d: c.phase_se_dicow(d, "bhtd", [60.0] * 2),
     "ancestry": c.phase_ancestry, "psi": c.phase_psi}}[phase](dev)
"""
PHASES = ("encoder", "train", "greedy", "beam", "se_dicow", "ancestry", "psi")
# the main-shape line each kernel phase prints, in every checkout's format
KERNEL_LINES = {"ancestry": r"\[ancestry\] Bb 10 H 20 T 448 pos 224 bfloat16:",
                "psi": r"\[psi\] P \(2, 51867, 375\) float32,"}
# the log tag of each decode phase
DECODES = {"greedy": "greedy", "beam": "beam_joint",
           "se_dicow": "se_dicow_beam_joint_bhtd"}


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
                or "s/1 steps" in line or "ms per beam step" in line
                or ("audio-s/s" in line and line.startswith(
                    ("[beam_joint]", "[se_dicow_beam_joint_bhtd]")))
                or any(re.match(pat, line) for pat in KERNEL_LINES.values())]
        print(f"=== {tree} (exit {proc.returncode})")
        print("\n".join(keep))
        enc = re.search(r"16 windows: kernel ([0-9.]+) ms", out)
        steps = [float(x) for x in re.findall(r"\(([0-9.]+) s/1 steps\)", out)]
        loop = re.search(r"([0-9.]+) ms/step", out)
        record = {"tree": str(tree), "exit": proc.returncode,
                  "encoder_ms_16_windows": enc and float(enc.group(1)),
                  "micro_batch_s": steps,
                  "greedy_loop_ms_per_step": loop and float(loop.group(1))}
        for phase, tag in DECODES.items():
            rate = re.search(rf"\[{tag}\] .*?([0-9.]+) audio-s/s", out)
            step = re.search(rf"\[{tag}\] .*?([0-9.]+) ms per beam step",
                             out)
            record[f"{phase}_audio_s_per_s"] = rate and float(rate.group(1))
            if phase != "greedy":
                record[f"{phase}_ms_per_beam_step"] = step and float(
                    step.group(1))
        for name, pat in KERNEL_LINES.items():
            hit = re.search(pat + r".*per call: kernel ([0-9.]+) ms.*"
                            r"device: kernel ([0-9.]+) ms", out)
            record[f"{name}_ms_per_call"] = hit and float(hit.group(1))
            record[f"{name}_device_ms"] = hit and float(hit.group(2))
        print(json.dumps(record))
        if proc.returncode != 0:
            print(out[-3000:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
