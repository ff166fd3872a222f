"""The CUDA kernels of the port against their plain PyTorch versions, on the
card: one command for all six.

Counterpart of scripts/tpu_kernel_check.py. The CPU test suite runs only the
plain versions (a CUDA kernel has no interpreter); this tool builds every
kernel and asserts, against the plain formulations the CPU suite holds
against the JAX package:

1. a full ``beam_search`` of a small fp32 DiCoW on the ancestry cache
   ('ancestry_pallas': the ancestry kernel) and on the standalone permute
   ('pallas': the kv_reorder kernels, in the 'bhtd' and 'tbhd' layouts)
   against the one-hot plain path: tokens identical, scores within 2e-5;
2. the two reorder kernels against their plain versions at the beam step's
   cache (4, 10, 20, 128, 64) and T 448, bf16 and fp32, bit for bit;
3. flash attention forward and backward (``sdpa`` under autograd) against
   autograd through the plain forward, fp32, within 2e-4;
4. the candidate CTC-psi gather + dot against its plain version at the
   turbo vocab, fp32 and bf16 posteriors, within 2e-5.

The tolerances are those of tests/test_torch_kernel_cuda.py. Each check also
asserts that its kernels launched. Exit code 0 = all six kernels match;
1 = a mismatch; 2 = no CUDA device (there is nothing to check on the CPU).

    python -m ts_asr_whisper_tpu_torch.scripts.cuda_kernel_check
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from .. import kernels
from ..decoding.beam import beam_search
from ..decoding.generation_config import GenerationConfig
from ..models import whisper as W
from ..models.config import DiCoWConfig
from ..models.dicow import build_dicow
from ..ops import attention as A
from ..ops import psi_gather as PG
from ..ops import reorder as R

BEAM_TOL = 2e-5
GRAD_TOL = 2e-4
FWD_TOL = (2e-5, 1e-5)   # atol, rtol of the fp32 forward
PSI_TOL = 2e-5


def _launched(names, before) -> None:
    for name in names:
        if kernels.launch_counts[name] == before[name]:
            raise AssertionError(f"{name} never launched")


def check_beam_ancestry_and_reorder(dev) -> None:
    v, eos, sot = 1700, 30, 31
    cfg = DiCoWConfig(
        vocab_size=v, num_mel_bins=24, d_model=256, encoder_layers=2,
        decoder_layers=2, encoder_attention_heads=4,
        decoder_attention_heads=4, encoder_ffn_dim=512,
        decoder_ffn_dim=512, max_source_positions=48,
        max_target_positions=64, decoder_start_token_id=sot,
        eos_token_id=eos, pad_token_id=eos, bos_token_id=eos,
        dtype="float32", use_fddt=True, use_pre_pos_fddt=True)
    model = build_dicow(cfg, dev, seed=7, flash=True)
    gen_cfg = GenerationConfig(
        eos_token_id=eos, pad_token_id=eos, bos_token_id=eos,
        decoder_start_token_id=sot, no_timestamps_token_id=v - 1502,
        return_timestamps=True, max_length=64, length_penalty=1.0)
    rng = np.random.default_rng(23)
    feats = rng.standard_normal((2, 24, 96)).astype(np.float32)
    raw = rng.random((2, 4, 48)).astype(np.float32)
    stno = raw / raw.sum(axis=1, keepdims=True)
    with torch.no_grad():
        enc = model.encoder(torch.from_numpy(feats).to(dev),
                            torch.from_numpy(stno).to(dev))
    prompt = torch.tensor([[sot, 50], [sot, 50]], device=dev)

    cases = (("onehot", "bhtd", ()), ("ancestry_pallas", "bhtd",
                                       ("ancestry_attn",)),
             ("pallas", "bhtd", ("kv_reorder_bhtd",)),
             ("pallas", "tbhd", ("kv_reorder_tbhd",)))
    outs = {}
    impl0, layout0 = R.get_reorder_impl(raw=True), W.get_kv_cache_layout()
    try:
        for impl, layout, names in cases:
            R.set_reorder_impl(impl)
            W.set_kv_cache_layout(layout)
            before = dict(kernels.launch_counts)
            outs[impl, layout] = beam_search(model, gen_cfg, enc, prompt,
                                             max_new_tokens=9, num_beams=4)
            torch.cuda.synchronize()
            _launched(names, before)
    finally:
        R.set_reorder_impl(impl0)
        W.set_kv_cache_layout(layout0)

    base = outs["onehot", "bhtd"]
    for (impl, layout), alt in outs.items():
        if impl == "onehot":
            continue
        if not torch.equal(base.sequences, alt.sequences):
            raise AssertionError(f"{impl} ({layout}): beam tokens diverge "
                                 "from the one-hot plain path")
        torch.testing.assert_close(
            alt.scores, base.scores, atol=BEAM_TOL, rtol=BEAM_TOL,
            msg=f"{impl} ({layout}): beam scores diverge")
        print(f"  beam '{impl}' ({layout}) vs 'onehot': tokens identical, "
              f"scores within {BEAM_TOL}")


def check_reorder(dev) -> None:
    gen = torch.Generator(device=dev).manual_seed(1)
    bb, n = 10, 5
    # each group's rows drawn with repeats from its own beams
    idx = (torch.randint(0, n, (bb,), device=dev, generator=gen)
           + torch.arange(bb, device=dev) // n * n).to(torch.int32)
    for t in (128, 448):
        for dtype in (torch.bfloat16, torch.float32):
            for layout, shape, fn, ref_fn in (
                    ("bhtd", (4, bb, 20, t, 64), R.reorder_bhtd,
                     R.reorder_bhtd_reference),
                    ("tbhd", (4, t, bb, 20, 64), R.reorder_tbhd,
                     R.reorder_tbhd_reference)):
                cache = torch.randn(shape, device=dev,
                                    generator=gen).to(dtype)
                before = dict(kernels.launch_counts)
                out = fn(cache, idx)
                torch.cuda.synchronize()
                _launched([f"kv_reorder_{layout}"], before)
                if not torch.equal(out, ref_fn(cache, idx)):
                    raise AssertionError(f"kv_reorder_{layout} {shape} "
                                         f"{dtype}: not bit for bit")
    print("  kv_reorder_bhtd / kv_reorder_tbhd at T 128 and 448, bf16 and "
          "fp32: bit for bit")


def check_flash_attention(dev) -> None:
    gen = torch.Generator(device=dev).manual_seed(3)
    shape = (2, 4, 300, 64)   # t >= 256 and not a multiple of the tile
    q, k, v = (torch.randn(shape, device=dev, generator=gen) * s
               for s in (64 ** -0.5, 1.0, 1.0))
    w = torch.randn(shape, device=dev, generator=gen)
    before = dict(kernels.launch_counts)
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    out = A.sdpa(*xs, flash=True)
    (out * w).sum().backward()
    torch.cuda.synchronize()
    _launched(["flash_attn_fwd", "flash_attn_bwd"], before)
    refs = [x.clone().requires_grad_() for x in (q, k, v)]
    ref = A.flash_mha_reference(*refs)
    (ref * w).sum().backward()
    torch.testing.assert_close(out, ref, atol=FWD_TOL[0], rtol=FWD_TOL[1],
                               msg="flash forward diverges from plain")
    for x, r, name in zip(xs, refs, "qkv"):
        torch.testing.assert_close(x.grad, r.grad, atol=GRAD_TOL,
                                   rtol=GRAD_TOL,
                                   msg=f"flash backward d{name} diverges")
    print(f"  flash attention fwd within {FWD_TOL[0]}, bwd (q/k/v grads) "
          f"within {GRAD_TOL} of plain attention (fp32)")


def check_psi(dev) -> None:
    rng = np.random.default_rng(0)
    b_audio, v, t, bb, k = 2, 51866, 375, 10, 512
    p = rng.random((b_audio, v, t), dtype=np.float32)
    p /= p.sum(axis=1, keepdims=True)
    ids = torch.from_numpy(np.sort(rng.choice(v, size=(bb, k)), axis=1)
                           .astype(np.int32)).to(dev)
    w = torch.from_numpy(rng.random((bb, t), dtype=np.float32)).to(dev)
    audio_idx = torch.arange(bb, dtype=torch.int32, device=dev) // (
        bb // b_audio)
    for dtype in (torch.float32, torch.bfloat16):
        p_vt = PG.padded_posterior(torch.from_numpy(p).to(dev), dtype)
        before = dict(kernels.launch_counts)
        out = PG.psi_gather_dot(p_vt, audio_idx, ids, w)
        torch.cuda.synchronize()
        _launched(["psi_gather_dot"], before)
        torch.testing.assert_close(
            out, PG.psi_gather_dot_reference(p_vt, audio_idx, ids, w),
            atol=PSI_TOL, rtol=PSI_TOL,
            msg=f"psi gather + dot ({dtype}) diverges from plain")
    print(f"  psi gather + dot at V {v}, T {t}, ids ({bb}, {k}), fp32 and "
          f"bf16 posteriors: within {PSI_TOL}")


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: the kernels run only on the GPU")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    print(f"device: {torch.cuda.get_device_name(dev)}")
    kernels.build_all(sorted(set(kernels.KERNEL_SOURCES.values())))
    checks = (("beam kernels (ancestry + reorder) in beam_search",
               check_beam_ancestry_and_reorder),
              ("reorder kernels", check_reorder),
              ("flash attention", check_flash_attention),
              ("psi gather + dot", check_psi))
    failed = []
    for label, check in checks:
        print(f"checking {label}...", flush=True)
        try:
            check(dev)
        except AssertionError as e:
            print(f"  FAILED: {e}")
            failed.append(label)
    print("kernel launches: " + json.dumps(kernels.launch_counts))
    if failed:
        print(f"FAILED: {', '.join(failed)}")
        return 1
    print("OK: all six CUDA kernels match their plain versions")
    return 0


if __name__ == "__main__":
    sys.exit(main())
