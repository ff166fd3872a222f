"""The two beam-step kernels' plain versions on the CPU, on inputs a beam
search really gives them, against the JAX package:

- ``ancestry_attention_reference`` against the TPU kernel (interpret mode) on
  an ancestry map built by beam search's own update rule, so beams share
  prefixes; pos as a Python int and as a one-element int32 tensor (what the
  card's kernel reads on the device). fp32; the reductions run in another
  order, so atol 1e-5.
- psi under ``ctc_p_bf16=True`` on the gather path: the port keeps the psi
  weights fp32 against a bf16 posterior, so it equals the JAX matmul path
  (whose einsum promotes the bf16 posterior to fp32) within 2e-5, and
  differs from the JAX gather path, which rounds the weights to bf16 first
  (psi_gather.py:175).
- ``init_ctc_state`` builds ``audio_idx`` as int32, and the rescorer gives
  the same scores and states with it as with int64 rows.
- the kernels' C entry points as the loader types them, and the extra
  ``-D`` defines a probe builds a variant with."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ts_asr_whisper_tpu.ops import ctc_prefix as JC
from ts_asr_whisper_tpu.ops import psi_gather as J
from ts_asr_whisper_tpu.ops.beam_attention import ancestry_attention
from ts_asr_whisper_tpu_torch.decoding import ctc_rescorer as R
from ts_asr_whisper_tpu_torch import kernels
from ts_asr_whisper_tpu_torch.kernels import launch_counts
from ts_asr_whisper_tpu_torch.ops import beam_attention as BA
from ts_asr_whisper_tpu_torch.ops import psi_gather as PG

ATOL = 1e-5
T_LEN, HEADS = 32, 3


def _ancestry_inputs(rng, b, n, t, h=HEADS, hd=64):
    bb = b * n
    q = rng.standard_normal((bb, h, 1, hd)).astype(np.float32) * 0.125
    kn, vn = (rng.standard_normal((bb, h, 1, hd)).astype(np.float32)
              for _ in range(2))
    ck, cv = (rng.standard_normal((bb, h, t, hd)).astype(np.float32)
              for _ in range(2))
    return q, kn, vn, ck, cv, BA.beam_search_history(rng, b, n, t)


def _jax_ancestry(q, kn, vn, ck, cv, hist, pos, n):
    return np.asarray(ancestry_attention(
        *(jnp.asarray(x) for x in (q, kn, vn)), jnp.asarray(ck)[None],
        jnp.asarray(cv)[None], jnp.asarray(hist), pos, 0, n, interpret=True))


POS = {"0": lambda t: 0, "1": lambda t: 1, "mid": lambda t: t // 2,
       "last": lambda t: t - 1}


@pytest.mark.parametrize("pos_class", sorted(POS))
@pytest.mark.parametrize("b,n", [(2, 1), (2, 5), (3, 5)])
def test_reference_matches_tpu_kernel_on_beam_history(b, n, pos_class):
    rng = np.random.default_rng(10 * b + n)
    args = _ancestry_inputs(rng, b, n, T_LEN)
    hist = args[-1]
    if n > 1:  # the map really shares prefixes across a group's beams
        assert (hist[:n, 0] == hist[0, 0]).all()
        assert len({tuple(r) for r in hist[:n]}) > 1
    pos = POS[pos_class](T_LEN)
    ref = _jax_ancestry(*args, pos, n)
    before = launch_counts["ancestry_attn"]
    out = BA.ancestry_attention(*(torch.from_numpy(x) for x in args), pos, n)
    assert launch_counts["ancestry_attn"] == before  # CPU: no launch
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("pos_class", sorted(POS))
def test_reference_takes_pos_as_a_device_scalar(pos_class):
    """pos as a one-element int32 tensor (the form a captured launch reads
    on the card) gives the int's result bit for bit, and the TPU kernel's."""
    b, n = 2, 5
    args = _ancestry_inputs(np.random.default_rng(3), b, n, T_LEN)
    pos = POS[pos_class](T_LEN)
    targs = [torch.from_numpy(x) for x in args]
    want = BA.ancestry_attention(*targs, pos, n)
    got = BA.ancestry_attention(
        *targs, torch.tensor([pos], dtype=torch.int32), n)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    np.testing.assert_allclose(got.numpy(), _jax_ancestry(*args, pos, n),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("b,n,t", [(2, 5, 1), (2, 5, 40), (3, 1, 9)])
def test_beam_search_history_follows_the_update_rule(b, n, t):
    """Group-local rows; the newest position is each row's own slot, as
    the step that wrote it claims; beams of a group share prefixes, so the
    oldest positions come from fewer rows than the group has."""
    hist = BA.beam_search_history(np.random.default_rng(t), b, n, t)
    assert hist.shape == (b * n, t) and hist.dtype == np.int32
    assert ((0 <= hist) & (hist < n)).all()
    np.testing.assert_array_equal(hist[:, -1], np.tile(np.arange(n), b))
    if n > 1 and t > 2:
        assert len({tuple(r[:-1]) for r in hist[:n]}) < n
        assert len(set(hist[:n, 0])) < n


def _psi_case(seed, b_audio=2, n=5, t=48, v_dec=400, k=30, eos=9):
    """CTC logits, prefix state and the rescorer's candidate mask (heavy
    ties), as ctc_rescorer.py builds them."""
    rng = np.random.default_rng(seed)
    v = v_dec + 1
    logits = rng.standard_normal((b_audio, t, v)).astype(np.float32) * 2
    logits[..., v_dec] += 3.0  # blank-heavy frames, as a CTC head gives
    bb = b_audio * n
    state = R.init_ctc_state(torch.from_numpy(logits), v_dec, num_beams=n,
                             k=k, p_bf16=True, psi_impl="gather")
    logp = torch.log_softmax(torch.from_numpy(logits), dim=-1).numpy()
    audio_idx = np.arange(bb) // n
    r = state.r_prev.numpy() \
        + rng.standard_normal((bb, t, 2)).astype(np.float32) * 0.1
    dl = rng.integers(0, 4, size=bb).astype(np.int32)
    dl[0] = 0
    last = rng.integers(10, v_dec, size=bb).astype(np.int32)
    scores = rng.integers(-4, 2, size=(bb, v_dec)).astype(np.float32)
    mask = R.candidate_mask(torch.from_numpy(scores), k, eos,
                            v_dec - 50).numpy()
    mask[1, last[1]] = True
    x_last = np.swapaxes(logp, 1, 2)[audio_idx, last]
    return dict(state=state, logp=logp, mask=mask, audio_idx=audio_idx,
                x_last=x_last, r=r, dl=dl, last=last, eos=eos, blank=v_dec,
                k_pad=-(-(k + 1) // 128) * 128)


def _posterior(c):
    """The state's bf16 posterior as (B_audio, V, T) fp32 numpy: both sides
    get the same bf16 values (exp in torch and in numpy may differ by an
    fp32 ulp, which can flip a bf16 rounding)."""
    return c["state"].p_vt.float().numpy()


def _port_psi(c):
    s = c["state"]
    return PG.ctc_psi_candidates(
        s.p_vt, torch.from_numpy(c["mask"]), s.audio_idx,
        torch.from_numpy(c["x_last"]), torch.from_numpy(c["r"]),
        torch.from_numpy(c["dl"]).long(), torch.from_numpy(c["last"]).long(),
        c["eos"], k_pad=c["k_pad"]).numpy()


def _live(c):
    live = c["mask"].copy()
    live[:, c["eos"]] = False
    return live


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_psi_gather_equals_the_jax_matmul_path(seed):
    """ctc_p_bf16 on the gather path: the bf16 posterior against fp32
    weights, as the JAX matmul path computes it (rtol/atol 2e-5: fp32 sums
    of the same products in another order)."""
    c = _psi_case(seed)
    assert c["state"].p_vt.dtype == torch.bfloat16
    assert c["state"].p_tv is None
    p_tv = jnp.asarray(np.swapaxes(_posterior(c), 1, 2)).astype(jnp.bfloat16)
    full = np.asarray(JC.ctc_psi_matmul(
        p_tv, jnp.asarray(c["x_last"]), jnp.asarray(c["r"]),
        jnp.asarray(c["dl"]), jnp.asarray(c["last"]), c["blank"], c["eos"]))
    want = np.where(c["mask"], full[:, :c["blank"]], JC.LOG_ZERO)
    out = _port_psi(c)
    np.testing.assert_array_equal(out > JC.LOG_ZERO / 2,
                                  want > JC.LOG_ZERO / 2)
    np.testing.assert_allclose(out, want, rtol=2e-5, atol=2e-5)


def test_bf16_psi_gather_differs_from_the_jax_gather_path():
    """The JAX gather path rounds the psi weights to bf16 before its dot
    (w4.astype(rows.dtype), psi_gather.py:175); the port does not. The two
    agree only to bf16 precision: a deliberate divergence, recorded in
    ROADMAP.md."""
    c = _psi_case(0)
    p4 = J.fold_posterior(jnp.asarray(_posterior(c)), dtype=jnp.bfloat16)
    ref = np.asarray(J.ctc_psi_candidates(
        p4, jnp.asarray(c["mask"]), jnp.asarray(c["audio_idx"]),
        jnp.asarray(c["x_last"]), jnp.asarray(c["r"]), jnp.asarray(c["dl"]),
        jnp.asarray(c["last"]), c["eos"], k_pad=c["k_pad"], interpret=True))
    out = _port_psi(c)
    live = _live(c)
    diff = np.abs(out[live] - ref[live]).max()
    assert 1e-4 < diff < 2e-2, diff  # bf16 weights: ~2^-9 per term


def test_init_ctc_state_makes_int32_audio_rows():
    logits = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 16, 41)).astype(np.float32))
    for n, impl in ((1, "auto"), (5, "gather"), (5, "matmul")):
        s = R.init_ctc_state(logits, 40, num_beams=n, k=8, psi_impl=impl)
        assert s.audio_idx.dtype == torch.int32
        assert s.audio_idx.tolist() == [i // n for i in range(2 * n)]


@pytest.mark.parametrize("psi_impl", ["gather", "matmul"])
def test_rescorer_is_the_same_with_int32_audio_rows(psi_impl):
    """One rescore and one state update with the int32 rows init_ctc_state
    now builds equal those with int64 rows, bit for bit."""
    rng = np.random.default_rng(5)
    n, v_dec, t = 5, 200, 24
    logits = torch.from_numpy(
        rng.standard_normal((2, t, v_dec + 1)).astype(np.float32))
    scorer = R.CTCRescorer(blank_id=v_dec, eos_id=7, timestamp_begin=150,
                           ctc_weight=0.3, k=20, prefix_len=3)
    state = R.init_ctc_state(logits, v_dec, num_beams=n, k=20,
                             psi_impl=psi_impl)
    tokens = torch.from_numpy(rng.integers(10, 150, size=(2 * n, 12)))
    scores = torch.log_softmax(torch.from_numpy(
        rng.standard_normal((2 * n, v_dec)).astype(np.float32)), dim=-1)
    beam_idx = torch.from_numpy(np.repeat(np.arange(2) * n, n)
                                + rng.integers(0, n, size=2 * n))
    outs = []
    for rows in (state.audio_idx, state.audio_idx.long()):
        s = state._replace(audio_idx=rows)
        fused, s = scorer.rescore(s, tokens, 6, scores)
        nxt = fused.argmax(dim=1)
        s = scorer.update_state(s, nxt, beam_idx)
        outs.append((fused, s.r_prev, s.score_prev))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def _c_signatures(source: str) -> dict:
    """extern "C" functions of csrc/<source>.cu -> their parameter types."""
    text = (kernels.CSRC / f"{source}.cu").read_text()
    return {m[1]: [p.strip() for p in m[2].split(",")] for m in re.finditer(
        r'extern "C" int (\w+)\(([^)]*)\)', text)}


@pytest.mark.parametrize("source", sorted(kernels.ENTRY_POINTS))
def test_entry_points_match_the_c_sources(source):
    """The loader types each entry point as its pointers, its ints and the
    stream; the C source declares exactly those (an argument dropped on one
    side only would shift every later one on the card)."""
    sigs = _c_signatures(source)
    for name, (n_ptrs, n_ints) in kernels.ENTRY_POINTS[source].items():
        kinds = ["ptr" if "*" in p else p.split()[0] for p in sigs[name]]
        assert kinds == ["ptr"] * n_ptrs + ["int"] * n_ints + ["ptr"], name
    for name in kernels.QUERIES.get(source, ()):
        assert [p.split()[0] for p in sigs[name]] == ["int"], name
    assert set(sigs) == set(kernels.ENTRY_POINTS[source]) \
        | set(kernels.QUERIES.get(source, ()))


def test_build_defines_make_their_own_library(tmp_path, monkeypatch):
    """A probe's -D defines reach nvcc and build into a directory of their
    own; the shipped build keeps its own."""
    calls = []

    def fake_nvcc(cmd, **_):
        calls.append(cmd)
        kernels.Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        return type("Done", (), {"returncode": 0, "stdout": "",
                                 "stderr": ""})()

    monkeypatch.setattr(kernels, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(kernels, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(kernels.subprocess, "run", fake_nvcc)
    shipped = kernels.build("psi_gather_dot")
    variant = kernels.build("psi_gather_dot", ("-DPSI_ROWS_PER_WARP=4",))
    assert shipped.parent != variant.parent
    assert "-DPSI_ROWS_PER_WARP=4" not in calls[0]
    assert calls[1][-4] == "-DPSI_ROWS_PER_WARP=4"
    assert kernels.build("psi_gather_dot") == shipped and len(calls) == 2
