"""Cross-check the port's WER engines against meeteval.

Counterpart of scripts/crosscheck_meeteval.py over the port's copies of
eval/{seglst,wer}.py. meeteval is not a dependency of this repository, so
the engines are validated in CI against brute-force oracles
(tests/test_wer.py, tests/test_orc.py) and a committed fixture pack
(tests/test_meeteval_pack.py, tests/test_torch_scripts_host.py). THIS tool
closes the remaining loop on any machine that has `pip install meeteval`:
it generates randomized multi-speaker sessions (overlaps, empty streams,
self-overlap, CJK-ish single-char words), scores each with both engines,
and asserts the error counts match exactly.

    python -m ts_asr_whisper_tpu_torch.scripts.crosscheck_meeteval \
        [--sessions 50] [--seed 0] [--write-pack <json>] [--force]

Exit code 0 = every session agreed on tcpWER, cpWER, and ORC-WER counts;
2 = meeteval is not installed.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from ..eval.seglst import SegLST
from ..eval.wer import (
    calc_session_cp_wer,
    calc_session_orc_wer,
    calc_session_tcorc_wer,
    calc_session_tcp_wer,
)

WORDS = ["yes", "no", "ok", "hello", "world", "meeting", "今", "日", "uh",
         "right", "thanks", "speaker", "one", "two", "three"]

TCP_KEYS = ("errors", "insertions", "deletions", "substitutions", "length")


def random_session(rng, max_speakers=4, max_segs=6, max_words=8):
    def streams(prefix):
        n_spk = int(rng.integers(1, max_speakers + 1))
        segs = []
        for s in range(n_spk):
            t = float(rng.uniform(0, 2))
            for _ in range(int(rng.integers(0, max_segs + 1))):
                n_words = int(rng.integers(1, max_words + 1))
                dur = float(rng.uniform(0.3, 3.0))
                segs.append({
                    "session_id": "s0",
                    "speaker": f"{prefix}{s}",
                    "start_time": round(t, 2),
                    "end_time": round(t + dur, 2),
                    "words": " ".join(rng.choice(WORDS, n_words)),
                })
                # occasional self-overlap / out-of-order starts
                t += dur * float(rng.uniform(0.5, 1.4))
        return segs

    return streams("ref_spk"), streams("hyp_spk")


def check_session(ref_segs, hyp_segs, expected, collar, label=""):
    """Score with OUR engines, compare with ``expected`` counts (from
    meeteval or a hand-verified pack). Returns a list of mismatch strings."""
    ref, hyp = SegLST(ref_segs), SegLST(hyp_segs)
    bad = []

    ours = calc_session_tcp_wer(ref, hyp, collar=collar)
    for key in TCP_KEYS:
        if key in expected.get("tcp", {}) and \
                ours[f"tcp_{key}"] != expected["tcp"][key]:
            bad.append(f"{label} tcpwer {key}: ours={ours[f'tcp_{key}']} "
                       f"expected={expected['tcp'][key]}")

    if "cp" in expected:
        ours_cp = calc_session_cp_wer(ref, hyp)
        if ours_cp["cp_errors"] != expected["cp"]["errors"]:
            bad.append(f"{label} cpwer errors: ours={ours_cp['cp_errors']} "
                       f"expected={expected['cp']['errors']}")

    if "orc" in expected:
        ours_orc = calc_session_orc_wer(ref, hyp)
        if ours_orc["orc_errors"] != expected["orc"]["errors"]:
            bad.append(f"{label} orcwer errors: ours={ours_orc['orc_errors']} "
                       f"expected={expected['orc']['errors']}")

    if "tcorc" in expected:
        # the reference's CHUNKED tcORC (wer.py:41-86): VAD-split groups,
        # per-group stream merge + time-constrained ORC. Hand-derivable per
        # group; equals plain meeteval tcorcwer only for single-group
        # sessions, so meeteval-sourced packs should record it only there.
        ours_tc = calc_session_tcorc_wer(ref, hyp, collar=collar)
        for key in TCP_KEYS:
            if key in expected["tcorc"] and \
                    ours_tc[f"tcorc_{key}"] != expected["tcorc"][key]:
                bad.append(
                    f"{label} tcorc {key}: ours={ours_tc[f'tcorc_{key}']} "
                    f"expected={expected['tcorc'][key]}")
    return bad


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sessions", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--collar", type=float, default=5.0)
    ap.add_argument("--write-pack", type=Path, default=None,
                    help="write sessions + meeteval counts to this JSON so "
                         "the verdict persists (tests/test_meeteval_pack.py "
                         "validates committed packs)")
    ap.add_argument("--force", action="store_true",
                    help="write the pack even when sessions mismatched "
                         "(by default a failing run refuses to write: the "
                         "pack's purpose is a persisted PASSING verdict)")
    args = ap.parse_args(argv)

    try:
        import meeteval  # noqa: F401
        from meeteval.io.seglst import SegLST as MSegLST
        from meeteval.wer.api import cpwer, orcwer, tcpwer
    except ImportError:
        print("meeteval is not installed; run this on a machine with "
              "`pip install meeteval` to cross-validate the WER engines.")
        return 2

    rng = np.random.default_rng(args.seed)
    failures = 0
    pack_sessions = []
    for i in range(args.sessions):
        ref, hyp = random_session(rng)
        if not ref or not hyp:
            continue
        m_ref, m_hyp = MSegLST(ref), MSegLST(hyp)

        theirs_tcp = tcpwer(reference=m_ref, hypothesis=m_hyp,
                            collar=args.collar)["s0"]
        theirs_cp = cpwer(reference=m_ref, hypothesis=m_hyp)["s0"]
        theirs_orc = orcwer(reference=m_ref, hypothesis=m_hyp)["s0"]
        expected = {
            "tcp": {k: int(getattr(theirs_tcp, k)) for k in TCP_KEYS},
            "cp": {"errors": int(theirs_cp.errors)},
            "orc": {"errors": int(theirs_orc.errors)},
        }
        bad = check_session(ref, hyp, expected, args.collar, label=f"[{i}]")
        for line in bad:
            print(line)
        failures += len(bad)
        pack_sessions.append({"ref": ref, "hyp": hyp, **expected})

    if args.write_pack is not None and failures and not args.force:
        print(f"refusing to write pack: {failures} mismatching counts "
              "(a committed pack would permanently fail "
              "test_meeteval_pack); pass --force to write anyway")
    elif args.write_pack is not None:
        meta = {"source": f"meeteval {getattr(meeteval, '__version__', '?')}",
                "collar": args.collar, "seed": args.seed,
                "sessions": len(pack_sessions),
                "all_matched_at_capture": failures == 0}
        args.write_pack.parent.mkdir(parents=True, exist_ok=True)
        args.write_pack.write_text(json.dumps(
            {"meta": meta, "sessions": pack_sessions}, indent=1))
        print(f"wrote {len(pack_sessions)}-session pack to {args.write_pack}")

    if failures:
        print(f"FAILED: {failures} mismatching counts")
        return 1
    print(f"OK: {args.sessions} sessions, all tcpWER/cpWER/ORC counts match")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
