"""The ancestry beam attention of the port on the CPU: its plain version
against the TPU kernel (``ancestry_attention`` in interpret mode), and one
decoder step (``decoder_cached_ancestry``) against the JAX package's.
fp32 throughout; the reductions run in another order, so atol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_utils import make_pair
from ts_asr_whisper_tpu.models import whisper as jw
from ts_asr_whisper_tpu.ops.beam_attention import ancestry_attention
from ts_asr_whisper_tpu_torch.kernels import launch_counts
from ts_asr_whisper_tpu_torch.ops import beam_attention as BA

ATOL = 1e-5


def _inputs(rng, b, n, h, t, hd=64):
    bb = b * n
    q = rng.standard_normal((bb, h, 1, hd)).astype(np.float32) * 0.125
    kn, vn = (rng.standard_normal((bb, h, 1, hd)).astype(np.float32)
              for _ in range(2))
    ck, cv = (rng.standard_normal((bb, h, t, hd)).astype(np.float32)
              for _ in range(2))
    hist = rng.integers(0, n, size=(bb, t)).astype(np.int32)
    return q, kn, vn, ck, cv, hist


@pytest.mark.parametrize("n,pos,t", [(1, 3, 8), (3, 1, 16), (3, 9, 16),
                                     (5, 15, 16), (5, 40, 64), (2, 0, 8)])
def test_reference_matches_tpu_kernel(rng, n, pos, t):
    q, kn, vn, ck, cv, hist = _inputs(rng, 2, n, 2, t)
    ref = ancestry_attention(*(jnp.asarray(x) for x in (q, kn, vn)),
                             jnp.asarray(ck)[None], jnp.asarray(cv)[None],
                             jnp.asarray(hist), pos, 0, n, interpret=True)
    before = launch_counts["ancestry_attn"]
    out = BA.ancestry_attention(*(torch.from_numpy(x) for x in
                                  (q, kn, vn, ck, cv, hist)), pos, n)
    assert launch_counts["ancestry_attn"] == before  # CPU: no launch
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


def test_reference_reads_ancestors_not_own_rows(rng):
    """Row b at t < pos reads cache row (b // n) * n + hist[b, t]; the slot
    at pos is never read; positions past pos carry no weight."""
    n, t, pos = 3, 6, 4
    q, kn, vn, ck, cv, hist = _inputs(rng, 1, n, 1, t)
    args = [torch.from_numpy(x) for x in (q, kn, vn, ck, cv, hist)]
    out = BA.ancestry_attention_reference(*args, pos, n)
    ck2, cv2 = args[3].clone(), args[4].clone()
    ck2[:, :, pos:] = 1e3   # stale slot and the future: must not matter
    cv2[:, :, pos:] = 1e3
    out2 = BA.ancestry_attention_reference(*args[:3], ck2, cv2, args[5],
                                           pos, n)
    torch.testing.assert_close(out, out2, atol=0, rtol=0)
    # brute force for row 1
    b = 1
    rows = [hist[b, s] for s in range(pos)]
    keys = np.stack([ck[r, 0, s] for s, r in enumerate(rows)] + [kn[b, 0, 0]])
    vals = np.stack([cv[r, 0, s] for s, r in enumerate(rows)] + [vn[b, 0, 0]])
    s = keys @ q[b, 0, 0]
    p = np.exp(s - s.max())
    p /= p.sum()
    np.testing.assert_allclose(out[b, 0, 0].numpy(), p @ vals, atol=ATOL)


@pytest.mark.parametrize("n", [1, 3])
def test_decoder_step_matches_jax(rng, n):
    jcfg, params, _, model = make_pair(seed=2)
    b, t_max, pos = 2, 12, 5
    bb = b * n
    d = jcfg.d_model
    enc = rng.standard_normal((b, 300, d)).astype(np.float32)
    cache = {k: rng.standard_normal(
        (jcfg.decoder_layers, bb, jcfg.decoder_attention_heads, t_max,
         d // jcfg.decoder_attention_heads)).astype(np.float32) * 0.5
        for k in ("k", "v")}
    hist = rng.integers(0, n, size=(bb, t_max)).astype(np.int32)
    ids = rng.integers(0, jcfg.vocab_size, size=(bb, 1))
    cross = jw.precompute_cross_kv(params["decoder"], jcfg, jnp.asarray(enc))
    ref_h, ref_c = jw.decoder_cached_ancestry(
        params["decoder"], jcfg, jnp.asarray(ids), pos,
        {k: jnp.asarray(v) for k, v in cache.items()}, cross,
        jnp.asarray(hist), n, attn_impl="pallas")
    dec = model.decoder
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    with torch.no_grad():
        tcross = dec.precompute_cross_kv(torch.from_numpy(enc))
        out = dec.decoder_cached_ancestry(torch.from_numpy(ids), pos, tcache,
                                          tcross, torch.from_numpy(hist), n)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_h), atol=1e-4,
                               rtol=1e-4)
    for k in ("k", "v"):  # the new token's K/V appended at pos, in place
        np.testing.assert_allclose(tcache[k].numpy(), np.asarray(ref_c[k]),
                                   atol=1e-5, rtol=1e-5)
