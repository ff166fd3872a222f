"""Multi-talker WER engines: tcpWER, cpWER, ORC-WER, chunked tcORC-WER.

Clean-room implementations of the metrics the reference obtains through
meeteval (the reference's src/utils/wer.py:30-185), backed by the native
C++ time-constrained Levenshtein (eval/native.py):

- tcpWER: per-speaker word streams with character-proportional pseudo word
  timings (hypothesis words as interval centers, i.e. points), +-collar on
  the hypothesis side, optimal speaker permutation via Hungarian assignment
  with empty-stream padding (missed/false-alarm speakers);
- cpWER: same assignment over plain Levenshtein distances;
- ORC-WER: optimal assignment of reference utterances to hypothesis streams
  via the exact polynomial segmental DP (eval/orc.py) — meeteval-equivalent
  at any session size; the chunked tcORC variant additionally applies the
  +-collar time constraint per ~5 s VAD-split group, mirroring the
  reference's meeteval.wer.tcorcwer(..., collar) calls (wer.py:41-86).

Shared utilities (pseudo timings, VAD chunking, stream merge, aggregation)
live in eval/wer_utils.py, mirroring the reference's own wer.py/wer_utils.py
seam; they are re-exported here for backward compatibility.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
from scipy.optimize import linear_sum_assignment

from .native import (
    levenshtein,
    pairwise_tclev_matrix,
    time_constrained_levenshtein,
)
from .seglst import SegLST, create_dummy_seglst, filter_empty_segments
from .wer_utils import (  # noqa: F401  (re-exported for API compatibility)
    _Vocab,
    _map_to_split,
    _segment_word_times,
    _speaker_streams,
    aggregate_wer_metrics,
    create_vad_mask,
    find_group_splits,
    merge_streams,
)

# ---------------------------------------------------------------------------
# permutation-based metrics (cpWER / tcpWER)
# ---------------------------------------------------------------------------


def _permutation_wer(ref_streams: dict, hyp_streams: dict,
                     collar: Optional[float]) -> dict:
    ref_keys = sorted(ref_streams)
    hyp_keys = sorted(hyp_streams)
    n = max(len(ref_keys), len(hyp_keys))
    empty = (np.zeros(0, np.int32), np.zeros(0, np.float64),
             np.zeros(0, np.float64))
    refs = [ref_streams[k] for k in ref_keys] + [empty] * (n - len(ref_keys))
    hyps = [hyp_streams[k] for k in hyp_keys] + [empty] * (n - len(hyp_keys))

    if collar is not None:
        cost = pairwise_tclev_matrix(refs, hyps, collar)
    else:
        cost = np.zeros((n, n), dtype=np.int64)
        for r in range(n):
            for h in range(n):
                cost[r, h], _ = levenshtein(refs[r][0], hyps[h][0])

    rows, cols = linear_sum_assignment(cost)
    errors = ins = dele = sub = 0
    missed = falarm = 0
    assignment = []
    for r, h in zip(rows, cols):
        if collar is not None:
            e, c = time_constrained_levenshtein(
                refs[r][0], refs[r][1], refs[r][2],
                hyps[h][0], hyps[h][1], hyps[h][2], collar)
        else:
            e, c = levenshtein(refs[r][0], hyps[h][0])
        errors += e
        ins += c["insertions"]
        dele += c["deletions"]
        sub += c["substitutions"]
        ref_name = ref_keys[r] if r < len(ref_keys) else None
        hyp_name = hyp_keys[h] if h < len(hyp_keys) else None
        if ref_name is not None and hyp_name is None and len(refs[r][0]):
            missed += 1
        if ref_name is None and hyp_name is not None and len(hyps[h][0]):
            falarm += 1
        assignment.append((ref_name, hyp_name))

    length = int(sum(len(ref_streams[k][0]) for k in ref_keys))
    return {
        "error_rate": errors / length if length else float(errors > 0),
        "errors": int(errors), "length": length,
        "insertions": int(ins), "deletions": int(dele),
        "substitutions": int(sub),
        "missed_speaker": missed, "falarm_speaker": falarm,
        "scored_speaker": len(ref_keys),
        "assignment": assignment,
    }


def calc_session_tcp_wer(ref: SegLST, hyp: SegLST, collar: float) -> dict:
    vocab = _Vocab()
    ref_streams = _speaker_streams(filter_empty_segments(ref), vocab, "interval")
    hyp_streams = _speaker_streams(filter_empty_segments(hyp), vocab, "points")
    res = _permutation_wer(ref_streams, hyp_streams, collar)
    return {f"tcp_{k}" if k != "error_rate" else "tcp_wer": v
            for k, v in res.items()}


def calc_session_cp_wer(ref: SegLST, hyp: SegLST) -> dict:
    vocab = _Vocab()
    ref_streams = _speaker_streams(filter_empty_segments(ref), vocab, "interval")
    hyp_streams = _speaker_streams(filter_empty_segments(hyp), vocab, "points")
    res = _permutation_wer(ref_streams, hyp_streams, None)
    return {f"cp_{k}" if k != "error_rate" else "cp_wer": v
            for k, v in res.items()}


# ---------------------------------------------------------------------------
# ORC-WER (utterance-to-stream assignment) + chunked tcORC
# ---------------------------------------------------------------------------


def _orc_group(ref_utts: List[np.ndarray], hyp_streams: List[np.ndarray],
               ref_times=None, hyp_times=None,
               collar: Optional[float] = None) -> dict:
    """Exact optimal assignment of ref utterances to hyp streams via the
    segmental DP in eval/orc.py (polynomial — meeteval-equivalent, replacing
    the round-1 exponential enumeration + greedy fallback). With ``collar``
    the alignment is time-constrained (meeteval tcorcwer semantics)."""
    from .orc import exact_orc

    if not hyp_streams:
        hyp_streams = [np.zeros(0, np.int32)]
        hyp_times = [(np.zeros(0), np.zeros(0))]
    _, assign = exact_orc(ref_utts, hyp_streams, ref_times, hyp_times,
                          collar)

    # counts from the optimal assignment: stream vs concatenation of its
    # utterances in temporal order (the ORC objective itself)
    errors = ins = dele = sub = 0
    empty_i = np.zeros(0, np.int32)
    empty_t = np.zeros(0, np.float64)
    for si, hyp in enumerate(hyp_streams):
        idxs = [u for u, a in enumerate(assign) if a == si]
        ref_cat = np.concatenate([ref_utts[u] for u in idxs] or [empty_i])
        if collar is not None:
            rb = np.concatenate([ref_times[u][0] for u in idxs] or [empty_t])
            re_ = np.concatenate([ref_times[u][1] for u in idxs] or [empty_t])
            e, c = time_constrained_levenshtein(
                ref_cat, rb, re_, hyp, hyp_times[si][0], hyp_times[si][1],
                collar)
        else:
            e, c = levenshtein(ref_cat, hyp)
        errors += e
        ins += c["insertions"]
        dele += c["deletions"]
        sub += c["substitutions"]
    length = int(sum(len(u) for u in ref_utts))
    return {"errors": errors, "length": length, "insertions": ins,
            "deletions": dele, "substitutions": sub,
            "assignment": tuple(assign)}


def _seglst_orc(ref: SegLST, hyp: SegLST,
                collar: Optional[float] = None) -> dict:
    """Session/group ORC. With ``collar``: time-constrained (ref word
    intervals character-based, hyp words as interval centers — the same
    pseudo-timing styles as tcpWER / meeteval defaults)."""
    vocab = _Vocab()
    ref_utts, ref_times = [], []
    for seg in ref.sorted("start_time"):
        wt = _segment_word_times(seg, "interval")
        ref_utts.append(np.asarray([vocab[w] for w, _, _ in wt], np.int32))
        ref_times.append((np.asarray([b for _, b, _ in wt], np.float64),
                          np.asarray([e for _, _, e in wt], np.float64)))
    hyp_streams, hyp_times = [], []
    for spk, segs in sorted(hyp.groupby("speaker").items()):
        words, begins, ends = [], [], []
        for seg in segs.sorted("start_time"):
            for w, wb, we in _segment_word_times(seg, "points"):
                words.append(vocab[w])
                begins.append(wb)
                ends.append(we)
        hyp_streams.append(np.asarray(words, np.int32))
        hyp_times.append((np.asarray(begins, np.float64),
                          np.asarray(ends, np.float64)))
    return _orc_group(ref_utts, hyp_streams, ref_times, hyp_times, collar)


def _scatter_group_assignment(ref_f: SegLST, group_of, gid_parts) -> tuple:
    """Map per-group ORC assignments back onto ``ref_f``'s input segment
    order. Each group's assignment is in that group's sorted-by-start_time
    order (the order ``_seglst_orc`` enumerates ref utterances in); without
    this scatter, concatenating groups only matches the caller's order when
    the input SegLST is already time-sorted."""
    out = [None] * len(ref_f)
    for gid, part_assign in gid_parts:
        idxs = [i for i, s in enumerate(ref_f.segments) if group_of(s) == gid]
        idxs.sort(key=lambda i: ref_f.segments[i]["start_time"])
        for i, a in zip(idxs, part_assign):
            out[i] = a
    return tuple(out)


def calc_session_tcorc_wer(ref: SegLST, hyp: SegLST, group_duration=5,
                           time_step=0.01, collar=5) -> dict:
    """Chunked tcORC (wer.py:41-86): VAD-split into ~group_duration groups,
    per-group ORC after stream merging, error aggregation.

    ``tcorc_assignment`` aligns with the input ``ref`` segment order after
    empty-words segments are dropped; stream ids are per-group merged
    stream indices."""
    ref_f = filter_empty_segments(ref)
    hyp_f = filter_empty_segments(hyp)
    if not len(ref_f):
        return {"tcorc_wer": 0.0, "tcorc_errors": 0, "tcorc_length": 0,
                "tcorc_insertions": 0, "tcorc_deletions": 0,
                "tcorc_substitutions": 0, "tcorc_assignment": ()}
    ref_vad = create_vad_mask(ref_f.segments, time_step=time_step)
    hyp_vad = (create_vad_mask(hyp_f.segments, time_step=time_step)
               if len(hyp_f) else ref_vad)
    n = max(len(ref_vad), len(hyp_vad))
    vad = np.pad(ref_vad, (0, n - len(ref_vad))) | \
        np.pad(hyp_vad, (0, n - len(hyp_vad)))
    splits = np.array(find_group_splits(vad, group_duration, time_step)) \
        * time_step

    def group_of(seg):
        return _map_to_split(float(seg["start_time"]), splits) \
            if len(splits) else 0

    totals = {"errors": 0, "length": 0, "insertions": 0, "deletions": 0,
              "substitutions": 0}
    gid_parts = []
    group_ids = sorted({group_of(s) for s in ref_f} | {group_of(s) for s in hyp_f})
    for gid in group_ids:
        ref_g = ref_f.filter(lambda s: group_of(s) == gid)
        hyp_g = hyp_f.filter(lambda s: group_of(s) == gid)
        if not len(ref_g) and not len(hyp_g):
            continue
        if not len(hyp_g):
            hyp_g = create_dummy_seglst(str(gid))
        hyp_merged = merge_streams(hyp_g)
        res = _seglst_orc(ref_g, hyp_merged, collar=collar)
        for k in ("errors", "length", "insertions", "deletions",
                  "substitutions"):
            totals[k] += res[k]
        gid_parts.append((gid, res["assignment"]))
    totals["assignment"] = _scatter_group_assignment(ref_f, group_of,
                                                     gid_parts)
    out = {"tcorc_wer": (totals["errors"] / totals["length"]
                         if totals["length"] else 0.0)}
    out.update({f"tcorc_{k}": v for k, v in totals.items()})
    return out


def calc_session_orc_wer(ref: SegLST, hyp: SegLST,
                         group_duration: float = 30.0,
                         time_step: float = 0.01) -> dict:
    """Exact session ORC; when the joint stream grid exceeds the DP size
    guards (long multi-stream sessions), the session is split at joint
    silences into ~group_duration groups and each group solved exactly —
    the same cost-bounding the reference applies to tcORC (wer.py:41-86),
    here without stream merging or time constraint. Groups are independent
    only across true joint silences, so this is near-exact in practice but
    no longer guaranteed optimal; the exact path is always used when it
    fits.

    ``orc_assignment`` aligns with the input ``ref`` segment order after
    empty-words segments are dropped (both paths)."""
    ref_f = filter_empty_segments(ref)
    hyp_f = filter_empty_segments(hyp)
    from .orc import OrcGridTooLarge

    try:
        res = dict(_seglst_orc(ref_f, hyp_f))
        res["assignment"] = _scatter_group_assignment(
            ref_f, lambda s: 0, [(0, res["assignment"])])
    except OrcGridTooLarge:
        if not len(ref_f):
            # degrade instead of re-raising: with no reference words every
            # hypothesis word is an insertion under any assignment
            n_ins = sum(len(str(s["words"]).split()) for s in hyp_f)
            res = {"errors": n_ins, "length": 0, "insertions": n_ins,
                   "deletions": 0, "substitutions": 0, "assignment": ()}
            out = {"orc_wer": 0.0}
            out.update({f"orc_{k}": v for k, v in res.items()})
            return out
        ref_vad = create_vad_mask(ref_f.segments, time_step=time_step)
        hyp_vad = (create_vad_mask(hyp_f.segments, time_step=time_step)
                   if len(hyp_f) else ref_vad)
        n = max(len(ref_vad), len(hyp_vad))
        vad = np.pad(ref_vad, (0, n - len(ref_vad))) | \
            np.pad(hyp_vad, (0, n - len(hyp_vad)))
        splits = np.array(find_group_splits(vad, group_duration,
                                            time_step)) * time_step

        def group_of(seg):
            return _map_to_split(float(seg["start_time"]), splits) \
                if len(splits) else 0

        res = {"errors": 0, "length": 0, "insertions": 0, "deletions": 0,
               "substitutions": 0}
        gid_parts = []
        gids = sorted({group_of(s) for s in ref_f}
                      | {group_of(s) for s in hyp_f})
        for gid in gids:
            ref_g = ref_f.filter(lambda s: group_of(s) == gid)
            hyp_g = hyp_f.filter(lambda s: group_of(s) == gid)
            if not len(ref_g) and not len(hyp_g):
                continue
            if not len(hyp_g):
                hyp_g = create_dummy_seglst(str(gid))
            part = _seglst_orc(ref_g, hyp_g)
            for k in ("errors", "length", "insertions", "deletions",
                      "substitutions"):
                res[k] += part[k]
            gid_parts.append((gid, part["assignment"]))
        res["assignment"] = _scatter_group_assignment(ref_f, group_of,
                                                      gid_parts)
    out = {"orc_wer": res["errors"] / res["length"] if res["length"] else 0.0}
    out.update({f"orc_{k}": v for k, v in res.items()})
    return out


# ---------------------------------------------------------------------------
# per-session scoring (reference wer.py:109-185)
# ---------------------------------------------------------------------------


def calc_wer(out_dir, tcp_wer_hyp_json, tcorc_wer_hyp_json, ref_file,
             collar: int = 5, save_visualizations: bool = False,
             metrics_list: Optional[List[str]] = None) -> List[dict]:
    metrics_list = metrics_list or ["tcp_wer"]
    tcp_hyp = SegLST.load(tcp_wer_hyp_json)
    tcorc_hyp = SegLST.load(tcorc_wer_hyp_json)
    ref = SegLST.load(ref_file)
    session_id = ref.segments[0]["session_id"] if len(ref) else "unknown"
    if not len(tcp_hyp):
        tcp_hyp = create_dummy_seglst(session_id)
    if not len(tcorc_hyp):
        tcorc_hyp = create_dummy_seglst(session_id)

    row = {"session_id": session_id}
    if "cp_wer" in metrics_list:
        row.update(calc_session_cp_wer(ref, tcp_hyp))
    if "tcp_wer" in metrics_list:
        row.update(calc_session_tcp_wer(ref, tcp_hyp, collar))
    if "tcorc_wer" in metrics_list:
        row.update(calc_session_tcorc_wer(ref, tcorc_hyp, group_duration=5,
                                          time_step=0.01, collar=collar))
    if "orc_wer" in metrics_list:
        row.update(calc_session_orc_wer(ref, tcorc_hyp))
    if save_visualizations:
        try:
            from .viz import save_wer_visualization

            save_wer_visualization(ref, tcp_hyp, out_dir)
        except Exception:
            pass
    return [row]
