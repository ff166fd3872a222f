"""DER between two cutsets + optimal speaker alignment.

Counterpart of scripts/compute_der_between_cutsets.py over the port's copy
of data/manifests.py (reference utils/{compute_der_between_cutsets,
align_and_compute_der_between_cutsets}.py without the pyannote dependency):
frame-based DER (10 ms) with Hungarian speaker mapping; optionally rewrites
the hypothesis cutset's speaker labels to the mapped reference speakers so
enrollment selection can name real speakers (reference align...py:20-34).

    python -m ts_asr_whisper_tpu_torch.scripts.compute_der_between_cutsets \
        <ref_cutset> <hyp_cutset> [--align-output <cutset>]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
from scipy.optimize import linear_sum_assignment

from ..data.manifests import CutSet, load_manifest


def speaker_frames(cut, step=0.01):
    n = int(cut.duration / step) + 1
    masks = {}
    for sup in cut.supervisions:
        m = masks.setdefault(sup.speaker, np.zeros(n, dtype=bool))
        m[int(sup.start / step): int(sup.end / step)] = True
    return masks


def der_and_mapping(ref_cut, hyp_cut, step=0.01):
    ref = speaker_frames(ref_cut, step)
    hyp = speaker_frames(hyp_cut, step)
    ref_keys, hyp_keys = sorted(ref), sorted(hyp)
    n = max(len(ref_keys), len(hyp_keys))
    overlap = np.zeros((n, n))
    for i, r in enumerate(ref_keys):
        for j, h in enumerate(hyp_keys):
            ln = min(len(ref[r]), len(hyp[h]))
            overlap[i, j] = (ref[r][:ln] & hyp[h][:ln]).sum()
    rows, cols = linear_sum_assignment(-overlap)
    mapping = {hyp_keys[j]: ref_keys[i] for i, j in zip(rows, cols)
               if i < len(ref_keys) and j < len(hyp_keys)}

    # frame-based DER: missed + false alarm over ref speech; confusion is
    # absorbed into missed / false alarm in this per-speaker view
    ln = max([len(m) for m in list(ref.values()) + list(hyp.values())] or [1])
    ref_stack = np.zeros((len(ref_keys), ln), bool)
    hyp_stack = np.zeros((len(ref_keys), ln), bool)  # hyp mapped to ref rows
    for i, r in enumerate(ref_keys):
        ref_stack[i, : len(ref[r])] = ref[r]
    for h, r in mapping.items():
        i = ref_keys.index(r)
        hyp_stack[i, : len(hyp[h])] |= hyp[h]
    extra = np.zeros(ln, bool)
    for h in hyp_keys:
        if h not in mapping:
            extra[: len(hyp[h])] |= hyp[h]

    total = ref_stack.sum()
    missed = (ref_stack & ~hyp_stack).sum()
    falarm = (hyp_stack & ~ref_stack).sum() + extra.sum()
    der = (missed + falarm) / max(total, 1)
    return der, mapping, {"missed": int(missed), "falarm": int(falarm),
                          "speech": int(total)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("ref_cutset", type=Path)
    ap.add_argument("hyp_cutset", type=Path)
    ap.add_argument("--align-output", type=Path,
                    help="write hyp cutset with speakers mapped to reference")
    args = ap.parse_args(argv)

    refs = {c.recording_id: c for c in load_manifest(args.ref_cutset)}
    hyps = load_manifest(args.hyp_cutset)
    ders = {}
    out_cuts = []
    for cut in hyps:
        rid = cut.recording_id
        if rid not in refs:
            continue
        der, mapping, stats = der_and_mapping(refs[rid], cut)
        ders[rid] = {"der": der, **stats}
        if args.align_output:
            for sup in cut.supervisions:
                sup.speaker = mapping.get(sup.speaker, "-1")
            out_cuts.append(cut)
    if args.align_output:
        CutSet(out_cuts).to_file(args.align_output)
    overall = (sum(d["missed"] + d["falarm"] for d in ders.values())
               / max(sum(d["speech"] for d in ders.values()), 1))
    print(json.dumps({"per_session": ders, "overall_der": overall}, indent=2,
                     default=float))


if __name__ == "__main__":
    main()
