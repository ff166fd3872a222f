"""Word-level token timestamps: DTW over cross-attention alignment heads.

The reference inherits HF Whisper's ``return_token_timestamps`` machinery —
``_extract_token_timestamps`` (DTW over selected cross-attention heads) plus
the per-segment slicing in its custom segment retrieval
(the reference's src/models/dicow/generation.py:427-436,473-475,526-527).
No reference config enables it, but the capability exists, so it exists
here: the greedy decode loop collects the alignment heads' cross-attention
probabilities on-device (models/whisper.py::decoder_cached
``alignment_slots``), and this module runs the host-side extraction with
HF's exact semantics (transformers
``generation_whisper._extract_token_timestamps`` / ``_median_filter`` /
``_dynamic_time_warping``, validated token-for-token by
tests/test_token_timestamps.py).

Scope note: implemented for the greedy path (num_beams == 1). The beam path
would additionally need per-step beam-ancestry gathers of the collected
weights (HF's ``beam_indices`` unrolling); no reference run enables token
timestamps at all, so beam collection is explicitly out of scope.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def median_filter(x: np.ndarray, filter_width: int) -> np.ndarray:
    """Median filter along the last axis with reflect padding — numpy twin
    of HF's ``_median_filter`` (sort-based, ties resolved identically)."""
    if filter_width <= 0 or filter_width % 2 != 1:
        raise ValueError("`filter_width` should be an odd number")
    pad_width = filter_width // 2
    if x.shape[-1] <= pad_width:
        return x
    padded = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad_width, pad_width)],
                    mode="reflect")
    windows = np.lib.stride_tricks.sliding_window_view(
        padded, filter_width, axis=-1)
    return np.sort(windows, axis=-1)[..., pad_width]


def dynamic_time_warping(matrix: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Monotone alignment path minimizing the summed cost — bit-exact twin
    of HF's ``_dynamic_time_warping``: fp32 cost accumulation over an fp64
    matrix, and its tie-breaking (ties between the three predecessors fall
    through to the 'time step' move). Vectorized over ANTI-DIAGONALS: every
    cell's value is fp32(matrix + min3(three earlier cells)), an expression
    with no cross-cell reassociation, so the evaluation order is free and
    each diagonal computes as one numpy gather+compare instead of HF's
    pure-Python double loop (~100x fewer interpreter iterations at the
    1500-frame window size)."""
    output_length, input_length = matrix.shape
    matrix = np.asarray(matrix, dtype=np.float64)
    inf = np.float32(np.inf)
    cost = np.full((output_length + 1, input_length + 1), inf,
                   dtype=np.float32)
    trace = -np.ones((output_length + 1, input_length + 1), dtype=np.int8)
    cost[0, 0] = 0.0

    for d in range(2, output_length + input_length + 1):
        i_lo = max(1, d - input_length)
        i_hi = min(output_length, d - 1)
        if i_lo > i_hi:
            continue
        ii = np.arange(i_lo, i_hi + 1)
        jj = d - ii
        c0 = cost[ii - 1, jj - 1]
        c1 = cost[ii - 1, jj]
        c2 = cost[ii, jj - 1]
        t = np.where((c0 < c1) & (c0 < c2), 0,
                     np.where((c1 < c0) & (c1 < c2), 1, 2)).astype(np.int8)
        c = np.where(t == 0, c0, np.where(t == 1, c1, c2))
        cost[ii, jj] = (matrix[ii - 1, jj - 1] + c).astype(np.float32)
        trace[ii, jj] = t

    i = output_length
    j = input_length
    trace[0, :] = 2
    trace[:, 0] = 1
    text_indices: List[int] = []
    time_indices: List[int] = []
    while i > 0 or j > 0:
        text_indices.append(i - 1)
        time_indices.append(j - 1)
        t = trace[i, j]
        if t == 0:
            i -= 1
            j -= 1
        elif t == 1:
            i -= 1
        else:
            j -= 1
    return (np.asarray(text_indices[::-1], dtype=np.int64),
            np.asarray(time_indices[::-1], dtype=np.int64))


def extract_token_timestamps(
    weights: np.ndarray,           # (B, S, n_rows, T_enc) alignment probs
    num_input_ids: int,            # prompt length (timestamps forced to 0.0)
    seq_lengths: Sequence[int],    # per row: total valid tokens incl. prompt
    num_frames: Optional[np.ndarray] = None,  # (B,) valid mel frames or None
    time_precision: float = 0.02,
    median_filter_width: int = 7,
) -> np.ndarray:
    """HF ``_extract_token_timestamps`` on the greedy loop's collected
    weights. ``weights`` rows j correspond to query positions
    num_input_ids + j; HF's matrix covers the prompt forward's rows too but
    drops them (``weights[:, :, num_input_ids:]``), so the greedy collector
    never stores them. Rows are cropped to (longest sequence's generated
    count - 1) — HF has no cross-attention for the token produced by the
    final forward. Returns (B, num_input_ids + max_gen) seconds."""
    b = weights.shape[0]
    gen_lengths = [max(int(l) - num_input_ids, 0) for l in seq_lengths]
    max_gen = max(gen_lengths) if gen_lengths else 0
    n_rows = max(max_gen - 1, 0)
    timestamps = np.zeros((b, num_input_ids + max_gen), dtype=np.float32)
    if n_rows == 0:
        return timestamps
    weights = weights[:, :, :n_rows, :]

    for batch_idx in range(b):
        matrix = weights[batch_idx]
        if num_frames is not None:
            matrix = matrix[..., : int(num_frames[batch_idx]) // 2]
        # normalize over the token axis, median-filter over time, average
        # heads (HF order; std is the biased/population one, unbiased=False)
        std = matrix.std(axis=-2, keepdims=True)
        mean = matrix.mean(axis=-2, keepdims=True)
        matrix = (matrix - mean) / std
        matrix = median_filter(matrix, median_filter_width)
        matrix = matrix.mean(axis=0)                      # (n_rows, T)

        text_indices, time_indices = dynamic_time_warping(
            -matrix.astype(np.float64))
        jumps = np.pad(np.diff(text_indices), (1, 0), constant_values=1) \
            .astype(bool)
        jump_times = time_indices[jumps] * time_precision
        # token at prompt+j gets jump_times[j]; the last generated token
        # (no cross-attention row) duplicates the final jump time
        row = np.concatenate([np.zeros(num_input_ids, np.float32),
                              jump_times.astype(np.float32),
                              np.asarray([jump_times[-1]], np.float32)])
        timestamps[batch_idx, : row.shape[0]] = row
    return timestamps


def alignment_slots_from_heads(
    alignment_heads: Sequence[Sequence[int]],
    num_layers: int,
    num_heads: int,
) -> np.ndarray:
    """Build the (L, S, H) one-hot selection decoder_cached consumes from an
    HF-style ``alignment_heads`` list of [layer, head] pairs (the model's
    generation_config.json field)."""
    s = len(alignment_heads)
    out = np.zeros((num_layers, s, num_heads), dtype=np.float32)
    for slot, (layer, head) in enumerate(alignment_heads):
        out[int(layer), slot, int(head)] = 1.0
    return out
