"""Exact ORC-WER assignment via segmental DP over the joint stream grid.

meeteval's ORC-WER (the engine behind the reference's orc_wer / tcorc_wer,
the reference's src/utils/wer.py:41-106) assigns each reference utterance to
one hypothesis stream such that the total Levenshtein distance between each
stream and the concatenation of its assigned utterances (in temporal order)
is minimal. Round 1 enumerated assignments (exponential in #utterances, with
a greedy fallback past 8); this module computes the optimum with the
polynomial segmental DP:

    D_u[p1..pS] = min cost of consuming utterances 1..u against the stream
                  prefixes p1..pS (every prefix word is aligned or an
                  insertion)

Per utterance, per stream s, the transition is one Levenshtein band run along
axis s whose initial row is D_{u-1} — vectorized over the other stream axes,
with the standard unit-cost insertion closure computed as a running minimum
of (cost[p] - p). Complexity O(total_ref_words * S * prod(N_s+1)) time and
O(U * prod(N_s+1)) memory for backtracking.

The optional time constraint mirrors native/tclev.cc: a ref word may align
with a hyp word iff the hyp interval extended by +-collar overlaps the ref
interval. With it this computes meeteval's tcORC semantics (the reference
passes collar=5 into tcorcwer); without it, plain ORC.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

INF = np.int64(1) << 40
MAX_GRID_CELLS = 50_000_000  # joint-grid size guard
MAX_BACKTRACK_BYTES = 2_000_000_000  # choice arrays: n_utt * cells * 5 B


class OrcGridTooLarge(ValueError):
    """The exact DP would exceed the size guards; callers fall back to the
    silence-chunked caller (eval/wer.py::calc_session_orc_wer)."""


def _cummin_with_slope(base: np.ndarray, start: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """row[q] = min_{p<=q} base[p] + (q-p), propagating start[argmin].

    base/start: (..., N+1). The slope-1 closure is a running minimum of
    base[p]-p; the argmin is recovered from positions where the running
    minimum was (re)set.
    """
    n1 = base.shape[-1]
    ar = np.arange(n1, dtype=np.int64)
    vals = base - ar
    run = np.minimum.accumulate(vals, axis=-1)
    row = run + ar
    # last position achieving the running minimum
    hit = vals == run
    idx = np.where(hit, ar, -1)
    idx = np.maximum.accumulate(idx, axis=-1)
    out_start = np.take_along_axis(start, idx, axis=-1)
    return row, out_start


def _utt_pass(d_prev: np.ndarray, utt: np.ndarray, stream: np.ndarray,
              allowed: Optional[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """Consume one utterance on the LAST axis of d_prev.

    d_prev: (..., N+1) int64 costs; utt: (m,) int32; stream: (N,) int32;
    allowed: (m, N) bool or None. Returns (d_new, start) where start[...,q]
    is the stream position the utterance's alignment began at.
    """
    n1 = d_prev.shape[-1]
    start0 = np.broadcast_to(np.arange(n1, dtype=np.int64),
                             d_prev.shape).copy()
    row, start = _cummin_with_slope(d_prev, start0)
    for j, w in enumerate(utt):
        sub_cost = (stream != w).astype(np.int64)
        if allowed is not None:
            sub_cost = np.where(allowed[j], sub_cost, INF)
        # deletion of the ref word (stay at q) vs diagonal (consume one)
        cand_del = row + 1
        cand_sub = np.concatenate(
            [np.full(row.shape[:-1] + (1,), INF, np.int64),
             row[..., :-1] + sub_cost], axis=-1)
        take_sub = cand_sub < cand_del
        base = np.where(take_sub, cand_sub, cand_del)
        start_sub = np.concatenate(
            [start[..., :1], start[..., :-1]], axis=-1)
        base_start = np.where(take_sub, start_sub, start)
        row, start = _cummin_with_slope(base, base_start)
    return row, start


def exact_orc(
    ref_utts: Sequence[np.ndarray],
    hyp_streams: Sequence[np.ndarray],
    ref_times: Optional[Sequence[Tuple[np.ndarray, np.ndarray]]] = None,
    hyp_times: Optional[Sequence[Tuple[np.ndarray, np.ndarray]]] = None,
    collar: Optional[float] = None,
) -> Tuple[int, Tuple[int, ...]]:
    """Optimal utterance-to-stream assignment.

    ref_utts: per-utterance int32 word ids (temporal order);
    hyp_streams: per-stream int32 word ids;
    ref_times/hyp_times: matching (begin, end) float64 arrays when collar is
    given. Returns (total_errors, assignment) with assignment[u] = stream.
    """
    s = len(hyp_streams)
    if s == 0:
        hyp_streams = [np.zeros(0, np.int32)]
        hyp_times = [(np.zeros(0), np.zeros(0))] if collar is not None else None
        s = 1
    shape = tuple(len(h) + 1 for h in hyp_streams)
    cells = int(np.prod(shape))
    if (cells > MAX_GRID_CELLS
            or len(ref_utts) * cells * 5 > MAX_BACKTRACK_BYTES):
        raise OrcGridTooLarge(
            f"ORC joint grid {shape} x {len(ref_utts)} utterances exceeds "
            "the size guards; split the session into silence-bounded "
            "groups (calc_session_orc_wer does this automatically)")

    # D_0: every consumed hyp word is an insertion
    grids = np.meshgrid(*[np.arange(n, dtype=np.int64) for n in shape],
                        indexing="ij")
    d = sum(grids) if grids else np.zeros(shape, np.int64)
    d = np.ascontiguousarray(d)

    n_utt = len(ref_utts)
    choice_stream = np.zeros((n_utt,) + shape, dtype=np.int8)
    choice_start = np.zeros((n_utt,) + shape, dtype=np.int32)

    for u, utt in enumerate(ref_utts):
        best_d = None
        best_start = None
        for si in range(s):
            allowed = None
            if collar is not None:
                rb, re_ = ref_times[u]
                hb, he = hyp_times[si]
                # match allowed iff hyp interval +-collar overlaps ref word
                allowed = ((hb[None, :] - collar <= re_[:, None])
                           & (he[None, :] + collar >= rb[:, None]))
            dm = np.moveaxis(d, si, -1)
            row, start = _utt_pass(dm, utt, np.asarray(hyp_streams[si],
                                                       np.int32), allowed)
            row = np.moveaxis(row, -1, si)
            start = np.moveaxis(start, -1, si)
            if best_d is None:
                best_d, best_start = row, start
                continue
            better = row < best_d
            choice_stream[u] = np.where(better, si, choice_stream[u])
            best_start = np.where(better, start, best_start)
            best_d = np.where(better, row, best_d)
        choice_start[u] = best_start
        d = best_d

    total = int(d[tuple(n - 1 for n in shape)])

    # backtrack the assignment
    pos = [n - 1 for n in shape]
    assignment = [0] * n_utt
    for u in range(n_utt - 1, -1, -1):
        si = int(choice_stream[u][tuple(pos)])
        q = int(choice_start[u][tuple(pos)])
        assignment[u] = si
        pos[si] = q
    return total, tuple(assignment)
