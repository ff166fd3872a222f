"""Vectorized CTC prefix scoring of the port (Watanabe Alg. 2 / Seki et al.).

Counterpart of ts_asr_whisper_tpu/ops/ctc_prefix.py, function for function,
in plain torch: no kernel lives here. The alpha recursion is a log-depth
inclusive scan of composed log-semiring affine maps (9 rounds at T=375), as
the JAX package's ``lax.associative_scan``; the combine order differs, so
states agree with JAX to float rounding (~1e-6), not bit for bit.

Shapes: Bb = batch*beams hypotheses, K = candidate tokens per step,
T = CTC frames, V = vocab+1 (blank last).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

LOG_ZERO = -1e10


def _logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """log(e^a + e^b) with the JAX package's LOG_ZERO guard: two impossible
    terms give -inf, never NaN."""
    mx = torch.maximum(a, b)
    mx = torch.where(mx <= LOG_ZERO, 0.0, mx)
    return mx + torch.log(torch.exp(a - mx) + torch.exp(b - mx))


def initial_ctc_state(logp: torch.Tensor, blank: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """State of the empty prefix: r^b accumulates blank probability, r^n is
    impossible. logp (B, T, V) -> (r_prev (B, T, 2), score_prev (B,))."""
    b, t, _ = logp.shape
    r = torch.full((b, t, 2), LOG_ZERO, dtype=torch.float32,
                   device=logp.device)
    r[..., 1] = torch.cumsum(logp[..., blank].float(), dim=1)
    return r, torch.zeros(b, dtype=torch.float32, device=logp.device)


def ctc_prefix_scores(
    logp_vt: torch.Tensor,      # (B_audio, V, T) case-folded log-probs
    audio_idx: torch.Tensor,    # (Bb,) hypothesis -> audio row
    cand_ids: torch.Tensor,     # (Bb, K) candidate next tokens
    r_prev: torch.Tensor,       # (Bb, T, 2) prefix state
    decoded_len: torch.Tensor,  # (Bb,) scored tokens in the prefix
    last_label: torch.Tensor,   # (Bb,) last non-timestamp label
    blank: int,
    eos: int,
    with_states: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(log_psi (Bb, K), new_states (Bb, K, T, 2) or None). Candidate rows
    are gathered as contiguous T-rows of the vocab-major log-probs."""
    xs = logp_vt[audio_idx[:, None], cand_ids.long()].transpose(1, 2)
    x_blank = logp_vt[audio_idx, blank]                     # (Bb, T)
    return ctc_prefix_scores_from_xs(xs, x_blank, cand_ids, r_prev,
                                     decoded_len, last_label, blank, eos,
                                     with_states=with_states)


def psi_weights(r_prev: torch.Tensor, decoded_len: torch.Tensor):
    """Closed-form psi weights shared by the full-vocab matmul and the
    candidate gather (ops/psi_gather.py): (w (Bb, T) probability-domain
    weights <= 1, m (Bb,) the log-domain shift, r_sum (Bb, T))."""
    t_len = r_prev.shape[1]
    r_sum = _logaddexp(r_prev[..., 0], r_prev[..., 1])      # (Bb, T)
    t_idx = torch.arange(1, t_len, device=r_prev.device)
    mask_t = t_idx[None, :] >= decoded_len[:, None]         # (Bb, T-1)
    phi = torch.where(mask_t, r_sum[:, :-1], LOG_ZERO)
    init_w = decoded_len == 0
    m = torch.maximum(phi.amax(dim=1),
                      torch.where(init_w, 0.0, LOG_ZERO).float())
    w = torch.cat([torch.where(init_w, -m, LOG_ZERO)[:, None],
                   phi - m[:, None]], dim=1)                # (Bb, T)
    w = torch.where(w > LOG_ZERO / 2, torch.exp(torch.clamp(w, min=-87.0)),
                    0.0)
    return w, m, r_sum


def psi_match_scores(r_prev: torch.Tensor, x_last: torch.Tensor,
                     decoded_len: torch.Tensor) -> torch.Tensor:
    """Exact log(psi) of re-emitting the last label (blank-ending paths
    only): the last-label correction column of both psi paths. (Bb,)."""
    t_len = r_prev.shape[1]
    t_idx = torch.arange(1, t_len, device=r_prev.device)
    mask_t = t_idx[None, :] >= decoded_len[:, None]
    summand = torch.where(mask_t, r_prev[:, :-1, 1] + x_last[:, 1:],
                          LOG_ZERO)
    return torch.logsumexp(summand, dim=1)


def ctc_psi_matmul(
    p_tv: torch.Tensor,         # (B_audio, T, V) case-folded probabilities
    x_last: torch.Tensor,       # (Bb, T) log-probs of each hyp's last label
    r_prev: torch.Tensor,       # (Bb, T, 2)
    decoded_len: torch.Tensor,  # (Bb,)
    last_label: torch.Tensor,   # (Bb,)
    blank: int,
    eos: int,
) -> torch.Tensor:
    """Closed-form log(psi) for every vocab token at once, one beam-shared
    matmul in the probability domain: psi[v] = M + log(sum_t w[t] P[t, v])
    with the weights of ``psi_weights``. Returns psi (Bb, V) with the
    eos / blank / last-label semantics applied (ctc_prefix.py:103-157)."""
    b_audio, t_len, v = p_tv.shape
    bb = r_prev.shape[0]
    n = bb // b_audio

    w, m, r_sum = psi_weights(r_prev, decoded_len)
    psi = torch.bmm(w.reshape(b_audio, n, t_len), p_tv.float())
    psi = torch.log(torch.clamp(psi, min=1e-38)).reshape(bb, v) + m[:, None]

    has_match = decoded_len > 0
    psi_match = psi_match_scores(r_prev, x_last, decoded_len)
    vocab_ids = torch.arange(v, device=psi.device)
    is_match_col = (vocab_ids[None, :] == last_label[:, None]) \
        & has_match[:, None]
    psi = torch.where(is_match_col, psi_match[:, None], psi)

    psi[:, eos] = r_sum[:, -1]
    if eos != blank:
        psi[:, blank] = LOG_ZERO
    return psi


def float_keys(x: torch.Tensor) -> torch.Tensor:
    """Monotone integer encoding of float32 values (IEEE-754 total order),
    the JAX package's uint32 keys held in int64: equal floats give equal
    keys and the order of keys is the order of the values."""
    bits = x.float().contiguous().view(torch.int32).long() & 0xFFFFFFFF
    return torch.where(bits >= 0x80000000, (~bits) & 0xFFFFFFFF,
                       bits | 0x80000000)


def kth_largest_keys(x: torch.Tensor, k: int):
    """(keys, kth_key): ``keys`` is ``float_keys(x)`` and ``kth_key`` the
    k-th largest key per row, so ``keys >= kth_key[:, None]`` is the exact
    top-k membership with every tie at the threshold included. The JAX
    package finds the threshold by a 32-step binary search to avoid a TPU
    sort; here it is the last value of an integer top-k, which is exact."""
    keys = float_keys(x)
    return keys, torch.topk(keys, k, dim=1).values[:, -1]


def _scan_affine(planes):
    """Inclusive log-depth scan (Hillis-Steele) over axis 0 of the composed
    affine maps (m00, m10, m11, c0, c1); out[t] = map[t] o ... o map[0]."""
    p00, p10, p11, pc0, pc1 = planes
    n = p00.shape[0]
    d = 1
    while d < n:
        x00, x10, x11, xc0, xc1 = (p[:-d] for p in (p00, p10, p11, pc0, pc1))
        y00, y10, y11, yc0, yc1 = (p[d:] for p in (p00, p10, p11, pc0, pc1))
        # y is the later map: out = y o x
        n00 = y00 + x00
        n10 = _logaddexp(y10 + x00, y11 + x10)
        n11 = y11 + x11
        nc0 = _logaddexp(y00 + xc0, yc0)
        nc1 = _logaddexp(_logaddexp(y10 + xc0, y11 + xc1), yc1)
        p00, p10, p11, pc0, pc1 = (
            torch.cat([old[:d], new]) for old, new in
            ((p00, n00), (p10, n10), (p11, n11), (pc0, nc0), (pc1, nc1)))
        d *= 2
    return p00, p10, p11, pc0, pc1


def ctc_prefix_scores_from_xs(
    xs: torch.Tensor,           # (Bb, T, K) candidate log-probs per frame
    x_blank: torch.Tensor,      # (Bb, T) blank log-probs per frame
    cand_ids: torch.Tensor,     # (Bb, K)
    r_prev: torch.Tensor,       # (Bb, T, 2) prefix state
    decoded_len: torch.Tensor,  # (Bb,)
    last_label: torch.Tensor,   # (Bb,)
    blank: int,
    eos: int,
    with_states: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    bb, k = cand_ids.shape
    t_len = xs.shape[1]
    dev = xs.device
    xs = xs.float()
    x_blank = x_blank.float()

    # phi[b,t,k]: forward mass of the prefix usable before emitting c at
    # t+1; when c is the last label, only the blank-ending path counts
    r_sum = _logaddexp(r_prev[..., 0], r_prev[..., 1])      # (Bb, T)
    label_match = (cand_ids == last_label[:, None]) \
        & (decoded_len > 0)[:, None]
    phi = torch.where(label_match[:, None, :], r_prev[..., 1:2],
                      r_sum[..., None])                     # (Bb, T, K)

    first = (decoded_len == 0)[:, None]
    init_term = torch.where(first, xs[:, 0], LOG_ZERO)
    t_idx = torch.arange(1, t_len, device=dev)
    mask_t = t_idx[None, :] >= decoded_len[:, None]         # (Bb, T-1)
    summand = torch.where(mask_t[..., None], phi[:, :-1] + xs[:, 1:],
                          LOG_ZERO)
    log_psi = _logaddexp(init_term, torch.logsumexp(summand, dim=1))

    def finish(lp):
        lp = torch.where(cand_ids == eos, r_sum[:, -1][:, None], lp)
        if eos != blank:
            lp = torch.where(cand_ids == blank, LOG_ZERO, lp)
        return lp

    if not with_states:
        return finish(log_psi), None

    # alpha recursion: s[t] = A[t] (x) s[t-1] (+) c[t] in the log semiring
    # with A[t] = [[xs[t], -inf], [xb[t], xb[t]]], c[t] = [phi[t-1]+xs[t],
    # -inf] (ctc_prefix.py:223-266); the upper-right entry stays -inf under
    # composition, so each map is the 5 planes m00, m10, m11, c0, c1
    r_n0 = torch.where(first, xs[:, 0], LOG_ZERO)
    r_n0 = torch.where((decoded_len <= 0)[:, None], r_n0, LOG_ZERO)
    r_b0 = torch.full((bb, k), LOG_ZERO, device=dev)

    valid = (decoded_len[None, :] <= t_idx[:, None])[..., None]  # (T-1,Bb,1)
    xs_t = xs[:, 1:].permute(1, 0, 2)                       # (T-1, Bb, K)
    xb_t = x_blank[:, 1:].t()[..., None].expand_as(xs_t)
    phi_tm1 = phi[:, :-1].permute(1, 0, 2)

    m00 = torch.where(valid, xs_t, LOG_ZERO)
    m10 = torch.where(valid, xb_t, LOG_ZERO)
    c0 = torch.where(valid, phi_tm1 + xs_t, LOG_ZERO)
    c1 = torch.full_like(c0, LOG_ZERO)
    p00, p10, _, pc0, pc1 = _scan_affine((m00, m10, m10, c0, c1))
    rs_n = _logaddexp(p00 + r_n0[None], pc0)                # (T-1, Bb, K)
    rs_b = _logaddexp(p10 + r_n0[None], pc1)
    r_n_all = torch.cat([r_n0[None], rs_n])                 # (T, Bb, K)
    r_b_all = torch.cat([r_b0[None], rs_b])
    new_states = torch.stack([r_n_all, r_b_all], dim=-1).permute(1, 2, 0, 3)
    return finish(log_psi), new_states                      # (Bb, K, T, 2)
