"""Diarization adapter: run a diarization pipeline over a cutset and emit
RTTMs (reference utils/diarizen_diar.py + scripts/diarize.sh).

Counterpart of scripts/diarize.py over the port's copies of
data/{manifests,audio}.py:

    python -m ts_asr_whisper_tpu_torch.scripts.diarize <cutset> <out_dir> \
        [--backend oracle|diarizen]

Cutset in, per-recording RTTM out, an existing RTTM skipped:
  --backend diarizen   the external DiariZen pipeline (if installed)
  --backend oracle     RTTM from the cutset's own supervisions
                       (ground-truth diarization, for oracle decoding)
The external backend reads each cut rendered to a temporary wav
(reference diarizen_diar.py:22-72).
"""

from __future__ import annotations

import argparse
import tempfile
from pathlib import Path

from ..data.audio import save_wav
from ..data.manifests import load_manifest


def write_rttm(path: Path, rec_id: str, segments):
    with open(path, "w") as f:
        for seg in segments:
            f.write(f"SPEAKER {rec_id} 1 {seg['start']:.3f} "
                    f"{seg['duration']:.3f} <NA> <NA> {seg['speaker']} "
                    f"<NA> <NA>\n")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("cutset", type=Path)
    ap.add_argument("out_dir", type=Path)
    ap.add_argument("--backend", choices=["oracle", "diarizen"],
                    default="oracle")
    args = ap.parse_args(argv)
    args.out_dir.mkdir(parents=True, exist_ok=True)

    pipeline = None
    for cut in load_manifest(args.cutset):
        rec_id = cut.recording_id
        out = args.out_dir / f"{rec_id}.rttm"
        if out.exists():  # idempotent skip (diarizen_diar.py:36-38)
            continue
        if args.backend == "oracle":
            segs = [{"start": s.start, "duration": s.duration,
                     "speaker": s.speaker} for s in cut.supervisions]
            write_rttm(out, rec_id, segs)
            continue
        if pipeline is None:
            try:
                from diarizen.pipelines.inference import (  # type: ignore
                    DiariZenPipeline,
                )
            except ImportError as e:
                raise SystemExit(
                    "DiariZen is not installed; use --backend oracle or "
                    "install the external pipeline") from e
            pipeline = DiariZenPipeline.from_pretrained(
                "BUT-FIT/diarizen-wavlm-large-s80-md")
        with tempfile.NamedTemporaryFile(suffix=".wav") as tmp:
            save_wav(tmp.name, cut.load_audio(), cut.sampling_rate)
            diar = pipeline(tmp.name)
        segs = [{"start": turn.start, "duration": turn.end - turn.start,
                 "speaker": label}
                for turn, _, label in diar.itertracks(yield_label=True)]
        write_rttm(out, rec_id, segs)
    print(f"RTTMs in {args.out_dir}")


if __name__ == "__main__":
    main()
