"""Probe: candidate-restricted CTC psi against the full-vocab product, on the
card.

Counterpart of scripts/probe_psi_gather.py, at its envelope: the beam-5
batch-8 large-v3-turbo beam step (8 audio rows x 5 beams = 40 hypotheses,
T = 1500 posterior frames, the CTC vocab of 51867 with the blank, 500
candidates + EOS padded to 512 slots). Each stage of the port's two psi
paths is timed on the card, device time per call from
``utils/devicetime.py::measure_device_ms`` and the per-call time (host
wrapper included) from CUDA events:

  1. the full-vocab psi product (``ops/ctc_prefix.py::ctc_psi_matmul``),
     bf16 and fp32 posteriors;
  -  the candidate membership mask (``decoding/ctc_rescorer.py::
     candidate_mask``, which both paths build);
  2. the candidate-id extraction (``ops/psi_gather.py::extract_topk_ids``),
     verified against numpy;
  3. the ``psi_gather_dot`` kernel, fp32 and bf16 posteriors, with the
     bytes of its candidate rows per second;
  4. the dense scatter of the (Bb, K) psi back over the vocab;
  5. the plain gather formulation (``psi_gather_dot_reference``: an
     indexed gather of the candidate rows and an einsum), bf16 and fp32,
     against which the kernel's result is checked.

The Pallas kernel's group-size sweep of the JAX probe has no counterpart:
the CUDA kernel's design sweep is scripts/probe_beam_kernels.py. The state
is synthetic and made on the card from seed 0. Needs a CUDA device: exits 2
without one.

    python -m ts_asr_whisper_tpu_torch.scripts.probe_psi_gather [--quick]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .. import kernels
from ..decoding.ctc_rescorer import candidate_mask
from ..ops.ctc_prefix import LOG_ZERO, ctc_psi_matmul, psi_weights
from ..ops.psi_gather import (extract_topk_ids, padded_posterior,
                              psi_gather_dot, psi_gather_dot_reference)
from ..utils.devicetime import measure_device_ms

B_AUDIO, N_BEAMS, T, V = 8, 5, 1500, 51867   # CTC vocab incl. blank
BB = B_AUDIO * N_BEAMS
K = 512                                       # 500 candidates (+eos) padded
TS_BEGIN = 50364
EOS = 50257
# the kernel against the plain gather: fp32 sums of T products in another
# order (tests/test_torch_kernel_cuda.py)
PSI_TOL = 2e-5


def timed(fn, reps: int):
    """(device ms per call, ms per call from CUDA events, the result)."""
    out = fn()
    dev_ms = measure_device_ms(fn, reps=reps, warmup=2)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return dev_ms, a.elapsed_time(b) / reps, out


def line(label: str, dev_ms, call_ms, extra: str = "") -> None:
    dev = "not measured" if dev_ms is None else f"{dev_ms:8.3f} ms"
    print(f"{label:<36}: {dev} (per call {call_ms:.3f} ms){extra}",
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: this probe runs only on the GPU")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    reps = 5 if args.quick else 20
    dev = torch.device("cuda", torch.cuda.current_device())
    print(f"device {torch.cuda.get_device_name(dev)}  envelope: "
          f"B_audio={B_AUDIO} beams={N_BEAMS} T={T} V={V} K={K}", flush=True)

    gen = torch.Generator(device=dev).manual_seed(0)
    logp = torch.log_softmax(
        torch.randn(B_AUDIO, T, V, device=dev, generator=gen) * 2, dim=-1)
    r_prev = torch.randn(BB, T, 2, device=dev, generator=gen) * 2 - 8
    scores = torch.randn(BB, V - 1, device=dev, generator=gen)
    rng = np.random.default_rng(0)
    audio_idx = torch.arange(BB, dtype=torch.int32, device=dev) // N_BEAMS
    decoded_len = torch.from_numpy(rng.integers(0, 40, size=BB)).to(dev)
    last_label = torch.from_numpy(rng.integers(0, 1000, size=BB)).to(dev)
    blank = V - 1
    x_last = logp[audio_idx.long(), :, last_label]

    # ---- 1. the full-vocab product
    p_tv32 = torch.exp(logp)
    for name, p in (("bf16", p_tv32.to(torch.bfloat16)), ("fp32", p_tv32)):
        d, c, _ = timed(lambda: ctc_psi_matmul(
            p, x_last, r_prev, decoded_len, last_label, blank, EOS), reps)
        line(f"[1] ctc_psi_matmul {name} posterior", d, c)
    p_vt32 = padded_posterior(p_tv32.transpose(1, 2), torch.float32)
    del p_tv32, logp

    # ---- candidate mask (exact top-k membership, as rescore builds it)
    d, c, mask = timed(lambda: candidate_mask(scores, 500, EOS, TS_BEGIN),
                       reps)
    line("[-] membership mask (existing)", d, c)

    # ---- 2. extraction
    d, c, ids = timed(lambda: extract_topk_ids(mask, K), reps)
    line("[2] extract_topk_ids (searchsorted)", d, c)
    mnp, inp = mask.cpu().numpy(), ids.cpu().numpy()
    for b in range(BB):
        want = np.flatnonzero(mnp[b])
        if not (inp[b][: len(want)] == want).all():
            raise AssertionError(f"extraction differs from numpy in row {b}")
    print("    extraction verified vs numpy", flush=True)

    # ---- 3. the kernel
    w, m, _ = psi_weights(r_prev, decoded_len)
    p_vt16 = padded_posterior(p_vt32, torch.bfloat16)
    got = {}
    for name, p in (("fp32", p_vt32), ("bf16", p_vt16)):
        d, c, got[name] = timed(
            lambda: psi_gather_dot(p, audio_idx, ids, w), reps)
        gb = BB * K * T * p.element_size() / 1e9
        rate = ("" if d is None
                else f" ({gb / (d / 1e3):6.1f} GB/s of candidate rows)")
        line(f"[3] psi_gather_dot kernel {name}", d, c, rate)

    # ---- 4. dense scatter of the candidates' psi over the vocab
    psi_c = torch.log(torch.clamp(got["fp32"], min=1e-38)) + m[:, None]

    def scatter():
        tmp = torch.full((BB, V - 1), LOG_ZERO, dtype=torch.float32,
                         device=dev)
        tmp.scatter_(1, ids.long(), psi_c)
        return torch.where(mask, tmp, LOG_ZERO)

    d, c, _ = timed(scatter, reps)
    line("[4] dense scatter (Bb,K)->(Bb,V)", d, c)

    # ---- 5. the plain gather formulation, and the kernel against it
    for name, p in (("bf16", p_vt16), ("fp32", p_vt32)):
        d, c, ref = timed(
            lambda: psi_gather_dot_reference(p, audio_idx, ids, w), reps)
        line(f"[5] plain gather+einsum {name}", d, c)
        err = ((got[name] - ref).abs() / (ref.abs() + 1e-9)).max().item()
        print(f"    kernel vs plain gather {name} max rel err: {err:.2e}",
              flush=True)
        torch.testing.assert_close(got[name], ref, atol=PSI_TOL,
                                   rtol=PSI_TOL)
    print("kernel launches: " + json.dumps(kernels.launch_counts))
    return 0


if __name__ == "__main__":
    sys.exit(main())
