"""RTTM dir -> hypothesis cutset: attach diarization-hypothesis supervisions
onto an original cutset (reference utils/prepare_diar_cutset_from_rttm_dir.py).

Counterpart of scripts/prepare_diar_cutset_from_rttm_dir.py over the port's
copy of data/manifests.py:

    python -m \
        ts_asr_whisper_tpu_torch.scripts.prepare_diar_cutset_from_rttm_dir \
        <rttm_dir> <cutset> <output>

RTTM lines: SPEAKER <rec_id> <chan> <start> <dur> <NA> <NA> <spk> <NA> <NA>.
Speaker fields are rewritten to '<rec_id>_<spk>' so speakers stay unique
across recordings (reference main:10-55).
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..data.manifests import CutSet, SupervisionSegment, load_manifest


def read_rttm(path: Path):
    segs = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0] != "SPEAKER":
                continue
            segs.append({"recording_id": parts[1], "start": float(parts[3]),
                         "duration": float(parts[4]), "speaker": parts[7]})
    return segs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("rttm_dir", type=Path)
    ap.add_argument("cutset", type=Path)
    ap.add_argument("output", type=Path)
    args = ap.parse_args(argv)

    rttm_by_rec = {}
    for rttm in sorted(args.rttm_dir.glob("*.rttm")):
        for seg in read_rttm(rttm):
            rttm_by_rec.setdefault(seg["recording_id"], []).append(seg)

    out_cuts = []
    for cut in load_manifest(args.cutset):
        rec_id = cut.recording_id
        segs = rttm_by_rec.get(rec_id, [])
        cut.supervisions = [SupervisionSegment(
            id=f"{rec_id}-diar-{i}", recording_id=rec_id,
            start=s["start"], duration=s["duration"],
            speaker=f"{rec_id}_{s['speaker']}", text="")
            for i, s in enumerate(segs)]
        out_cuts.append(cut)
    CutSet(out_cuts).to_file(args.output)
    print(f"Wrote {len(out_cuts)} cuts to {args.output}")


if __name__ == "__main__":
    main()
