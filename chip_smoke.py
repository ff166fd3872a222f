#!/usr/bin/env python
"""Smoke run of the PyTorch port (ts_asr_whisper_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it breaks:
  1. the card: nvidia-smi name and power limit, torch and CUDA versions;
     no CUDA device -> exit 2, there is no CPU path;
  2. build the six CUDA kernels from the five sources of kernels/csrc with
     nvcc, one nvcc per source, all started together;
  3. flash attention vs its plain PyTorch version at the encoder's shapes,
     bf16 and fp32, output and row log-sum-exp, with errors and median
     times (CUDA events, warmed up), device time (torch.profiler), TFLOP/s
     and the share of the bound at the main shape;
     F.scaled_dot_product_attention timed beside it as a yardstick only;
  3b. the flash-attention backward vs its plain version, both fed the
     kernel forward's (out, lse), at the fine-tune shape (4, 20, 1500, 64)
     and T 1499, 1000 and 257, bf16 and fp32, timed with CUDA events and
     torch.profiler beside the backward of F.scaled_dot_product_attention;
     FlashMHA end to end against autograd through the plain forward in
     fp32;
  4. beam ancestry attention vs its plain version at beam 5 x batch 2,
     20 heads, cache lengths 128 and 448, bf16 and fp32;
  5. the candidate CTC-psi gather + dot vs its plain version at the turbo
     vocab (51866), 375 CTC frames, 10 hypotheses x 512 candidate slots,
     fp32 and bf16 posteriors from blank-dominant logits (so every frame
     weighs in each sum), and the psi it feeds against the CPU path;
     phases 4 and 5 time each call with CUDA events and, apart, the device
     time of its kernels with torch.profiler;
  5b. the two KV-cache reorder kernels ('bhtd' and 'tbhd') vs their plain
     versions, bit for bit, in bf16 and fp32, at the beam step's cache
     (4, 10, 20, 128, 64), at T 448 and at Bb 15 (batch 3 x 5), with source
     rows drawn with repeats, the identity and a reversal within groups;
     CUDA-event and profiler times beside torch.index_select's;
  6. the large-v3-turbo DiCoW encoder at fp32 on 2 windows, through the
     kernel and through plain attention;
  7. long-form greedy decode of a synthetic 16-row corpus (8 two-speaker
     recordings of 60 s) at large-v3-turbo width with random weights,
     through the decode entry point with the dicow_v3_greedy settings;
     every encoder layer must have run the flash kernel;
  8. long-form beam-5 joint-CTC decode (dicow_v3_beam_joint) of 8 rows
     (4 two-speaker recordings of 60 s, 4 calls of batch 2) at the same
     width: every beam step must have run the ancestry kernel in each
     decoder layer and the psi kernel once; both decodes must have scored
     with the native tcpWER library, not the numpy fallback;
  9. the DiCoW v3 fine-tune (+train=dicow_v3) through the training entry
     point (ModelTrainer) at the same width: 16 rows (8 two-speaker
     recordings of 30 s), 8 micro-batches of 4 with gradient accumulation
     over 2, 2 preheat updates then 2 base updates with a fresh optimizer,
     and the HF export: every loss finite, the flash forward and backward
     kernels launched in every encoder layer and the CTC head of every
     micro-batch, the preheat phase changing only preheat parameters, the
     base phase leaving the decoder bit-identical, the export loading
     strictly into the port's container;
 10. SE-DiCoW long-form beam-5 joint-CTC decode (se_dicow_beam_joint, 8 SCBs,
     self-enrollment from the recordings, CTC weight 0.3) of 4 rows (2
     two-speaker recordings of 60 s, 2 calls of batch 2) at the same width,
     with the standalone-permute reorder ('pallas') on the 'bhtd' cache:
     every beam step must have launched kv_reorder_bhtd twice (k and v) and
     the psi kernel once, the ancestry kernel never, and every encoder call
     the flash kernel in its 32 layers and 8 SCB cross-attentions;
 11. the same decode of 1 recording (2 rows) on the 'tbhd' cache:
     kv_reorder_tbhd twice per beam step, kv_reorder_bhtd never. The reorder
     impl and the cache layout are restored afterwards.
The line before the last is a JSON record of the kernels; the last line is
{"ok": true, "device": {...}}. Nothing here imports jax or the JAX package.
"""

from __future__ import annotations

import gc
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

# the port must never reach jax, nor any module of the JAX package
sys.modules["jax"] = None
sys.modules["ts_asr_whisper_tpu"] = None

import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
TURBO = {"vocab_size": 51866, "num_mel_bins": 128, "d_model": 1280,
         "encoder_layers": 32, "decoder_layers": 4,
         "encoder_attention_heads": 20, "decoder_attention_heads": 20,
         "encoder_ffn_dim": 5120, "decoder_ffn_dim": 5120,
         "max_source_positions": 1500, "max_target_positions": 448}
KERNELS = ("flash_attn_fwd", "flash_attn_bwd", "ancestry_attn",
           "psi_gather_dot", "kv_reorder_bhtd", "kv_reorder_tbhd")
ENC_SHAPE = (16, 20, 1500, 64)   # turbo encoder attention at batch 16
RAGGED_T = (257, 1000, 1499)
TOLS = {torch.float32: (2e-5, 1e-5),   # as tests/test_attention.py
        torch.bfloat16: (1e-2, 1e-2)}  # bf16 rounding of p and out dominates
# the forward's row log-sum-exp against the plain version's (atol = rtol):
# fp32 scores in both, the row sums in another order
LSE_TOL = 1e-5
# the backward at the fine-tune's micro-batch of 4
BWD_SHAPE = (4, 20, 1500, 64)
BWD_T = (1500, 1499, 1000, 257)
BWD_F32_TOL = 2e-4   # atol = rtol, as tests/test_attention.py:63
# bf16: relative error of dq/dk/dv in Frobenius norm; the bf16 rounding of
# ds and p before the products dominates
BWD_BF16_REL = 1e-2
# one H100 SXM (NVIDIA data sheet): dense bf16 tensor-core and fp32 rates,
# memory rate
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
# fp32 encoder, kernel vs plain attention: both fp32 with no TF32; the only
# difference is summation order (~1e-6 per attention), carried through 32
# residual layers and the FDDTs of a random-weight model
ENC_ATOL = 1e-3
# beam slice: dicow_v3_beam_joint decodes batch 2 with 5 beams
BEAMS, AUDIO_ROWS = 5, 2
ANC_T = (128, 448)               # generation_max_length 128; the model's max
ANC_TOLS = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-2, 1e-2)}
ANC_MAIN = (448, 224, torch.bfloat16)  # mid-way through a full-length decode
# CTC psi: the posterior has 375 frames (two stride-2 convs after the
# encoder); fp32 sums in another order
CTC_T, PSI_TOL = 375, 2e-5
# blank logit offset of the synthetic CTC posterior: blank takes ~99.3% of
# each frame, as a trained CTC head gives, so the psi weights w stay within
# 1e-3 of their maximum over (nearly) all 375 frames and every frame of a
# candidate row counts in its sum
BLANK_LOGIT, W_SPAN = 20.0, 300
# KV-cache reorder: the beam step's self-attention cache, (L, Bb, H, T, hd)
# in 'bhtd' and (L, T, Bb, H, hd) in 'tbhd', at (T, Bb): the decode's
# generation_max_length 128 at batch 2 x 5 (the main shape) and 3 x 5, and
# the model's maximum 448
REORDER_CASES = ((128, 10), (128, 15), (448, 10))
REORDER_KINDS = ("repeats", "identity", "reversal")
# SE-DiCoW: se_dicow_greedy.yaml's SCB count
SCB_LAYERS = 8


def log(msg: str) -> None:
    print(msg, flush=True)


def median_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def device_ms(fn, reps: int = 20):
    """Device time per call of ``fn``: the sum of its kernels' times in a
    torch.profiler trace of ``reps`` calls. Unlike ``median_ms`` it leaves
    out the host's time to reach the launch, which bounds small kernels.
    A trace that caught no kernel is taken again; None if none ever does."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA)
        if us > 0:
            return us / 1e3 / reps
    return None


def fmt_ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


def bound(flop: float, nbytes: float, dtype=torch.bfloat16) -> dict:
    """The least time the card could take: the larger of the operations
    over the peak rate for their type and the bytes over the memory rate."""
    t_ops = flop / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def sdpa_fwd(q, k, v):
    """F.scaled_dot_product_attention with the port's pre-scaled q: the
    yardstick of the flash kernels, never called by the port."""
    return torch.nn.functional.scaled_dot_product_attention(q, k, v,
                                                            scale=1.0)


def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    log(smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    if not torch.cuda.is_available():
        log("no CUDA device: this script runs only on the GPU")
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.cuda.get_device_name(0)


def phase_build() -> None:
    from ts_asr_whisper_tpu_torch import kernels

    sources = sorted({kernels.KERNEL_SOURCES[k] for k in KERNELS})
    t0 = time.perf_counter()
    kernels.build_all(sources)
    log(f"[build] {len(sources)} sources ({len(KERNELS)} kernels) in "
        f"parallel: {time.perf_counter() - t0:.1f} s")
    for name in sources:
        getattr(kernels, f"{name}_lib")()
        info = kernels.build_info[name]
        log(f"[build] {name}.cu -> sm_90a in {info['seconds']:.1f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")


def share(bound_ms: float, ms) -> str:
    return "not measured" if ms is None else f"{100 * bound_ms / ms:.1f}%"


def phase_kernel(dev) -> dict:
    """The forward kernel vs flash_mha_reference, output and row
    log-sum-exp, at the encoder's shapes; times with CUDA events (per call)
    and torch.profiler (device) beside F.scaled_dot_product_attention's."""
    from ts_asr_whisper_tpu_torch.ops import attention as A

    gen = torch.Generator(device=dev).manual_seed(0)
    main = {}
    cases = [(ENC_SHAPE, dt) for dt in (torch.bfloat16, torch.float32)]
    cases += [((16, 20, t, 64), dt) for t in RAGGED_T
              for dt in (torch.bfloat16, torch.float32)]
    for shape, dt in cases:
        q, k, v = (torch.randn(shape, device=dev, generator=gen) * s
                   for s in (0.125, 1.0, 1.0))
        q, k, v = (x.to(dt) for x in (q, k, v))
        out, lse = A.flash_mha_fwd(q, k, v, with_lse=True)
        out_nolse = A.flash_mha_fwd(q, k, v)
        ref, ref_lse = A.flash_mha_reference(q, k, v, with_lse=True)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        atol, rtol = TOLS[dt]
        ok = (torch.allclose(out.float(), ref.float(), atol=atol, rtol=rtol)
              and torch.allclose(lse, ref_lse, atol=LSE_TOL, rtol=LSE_TOL)
              and torch.equal(out, out_nolse))
        del ref, ref_lse, out_nolse
        ms = median_ms(lambda: A.flash_mha_fwd(q, k, v))
        plain_ms = median_ms(lambda: A.flash_mha_reference(q, k, v), reps=5)
        flop = 4 * shape[0] * shape[1] * shape[2] ** 2 * shape[3]
        log(f"[kernel] {tuple(shape)} {str(dt)[6:]}: max_abs_err {err:.3e} "
            f"(atol {atol}, rtol {rtol}), lse {lse_err:.3e} (atol/rtol "
            f"{LSE_TOL}) kernel {ms:.3f} ms ({flop / ms / 1e9:.1f} TFLOP/s) "
            f"plain {plain_ms:.3f} ms")
        if not ok:
            raise AssertionError(f"kernel disagrees at {shape} {dt}")
        if shape == ENC_SHAPE and dt == torch.bfloat16:
            dev_ms = device_ms(lambda: A.flash_mha_fwd(q, k, v))
            lib_ms = median_ms(lambda: sdpa_fwd(q, k, v))
            lib_dev_ms = device_ms(lambda: sdpa_fwd(q, k, v))
            nbytes = 4 * q.numel() * q.element_size()  # q, k, v in, out
            main = {"max_abs_err": err, "lse_max_abs_err": lse_err, "ms": ms,
                    "device_ms": dev_ms, "plain_ms": plain_ms,
                    **bound(flop, nbytes), "library_ms": lib_ms,
                    "library_device_ms": lib_dev_ms}
            tflops = ("not measured" if dev_ms is None
                      else f"{flop / dev_ms / 1e9:.1f} TFLOP/s")
            log(f"[kernel] {tuple(shape)} bf16 main shape: device "
                f"{fmt_ms(dev_ms)} ({tflops}, {share(main['bound_ms'], dev_ms)}"
                f" of the bound {main['bound_ms']:.4f} ms, "
                f"{main['bound_by']}); F.scaled_dot_product_attention "
                f"{lib_ms:.3f} ms per call, device {fmt_ms(lib_dev_ms)} "
                f"({share(main['bound_ms'], lib_dev_ms)} of the bound)")
        del q, k, v, out, lse
    torch.cuda.empty_cache()
    return main


def phase_flash_bwd(dev) -> dict:
    """The backward kernel vs flash_mha_bwd_reference at the fine-tune's
    shapes, both fed the kernel forward's (out, lse); then FlashMHA (kernel
    forward and backward) against autograd through the plain forward,
    fp32."""
    from ts_asr_whisper_tpu_torch.ops import attention as A

    gen = torch.Generator(device=dev).manual_seed(6)
    b, h, _, d = BWD_SHAPE
    main = {}
    for t in BWD_T:
        for dt in (torch.bfloat16, torch.float32):
            q, k, v, g = (torch.randn(b, h, t, d, device=dev, generator=gen)
                          * s for s in (0.125, 1.0, 1.0, 1.0))
            q, k, v, g = (x.to(dt) for x in (q, k, v, g))
            o, lse = A.flash_mha_fwd(q, k, v, with_lse=True)
            args = (q, k, v, o, lse, g)
            out = A.flash_mha_bwd(*args)
            ref = A.flash_mha_bwd_reference(*args)
            torch.cuda.synchronize()
            errs, rels, ok = [], [], True
            for x, r in zip(out, ref):
                x, r = x.float(), r.float()
                errs.append((x - r).abs().max().item())
                rels.append(((x - r).norm() / r.norm()).item())
                if dt == torch.float32:
                    ok = ok and torch.allclose(x, r, atol=BWD_F32_TOL,
                                               rtol=BWD_F32_TOL)
                else:
                    ok = ok and rels[-1] <= BWD_BF16_REL
            ok = ok and all(x.dtype == dt for x in out)
            del ref
            tol = (f"atol/rtol {BWD_F32_TOL}" if dt == torch.float32
                   else f"Frobenius rel <= {BWD_BF16_REL}")
            ms = median_ms(lambda: A.flash_mha_bwd(*args))
            plain_ms = median_ms(lambda: A.flash_mha_bwd_reference(*args),
                                 reps=5)
            flop = 10 * b * h * t * t * d
            log(f"[flash_bwd] ({b}, {h}, {t}, {d}) {str(dt)[6:]}: dq/dk/dv "
                f"max_abs_err {', '.join(f'{e:.3e}' for e in errs)}, "
                f"Frobenius rel {', '.join(f'{r:.3e}' for r in rels)} "
                f"({tol}) kernel {ms:.3f} ms ({flop / ms / 1e9:.1f} TFLOP/s) "
                f"plain {plain_ms:.3f} ms")
            if not ok:
                raise AssertionError(f"backward kernel disagrees at T {t} "
                                     f"{dt}")
            if t == BWD_SHAPE[2] and dt == torch.bfloat16:
                dev_ms = device_ms(lambda: A.flash_mha_bwd(*args))
                qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))
                lib_out = sdpa_fwd(qr, kr, vr)

                def lib_bwd():
                    torch.autograd.grad(lib_out, (qr, kr, vr), g,
                                        retain_graph=True)

                lib_ms = median_ms(lib_bwd)
                lib_dev_ms = device_ms(lib_bwd)
                # q k v g out and lse in, dq dk dv out
                nbytes = (8 * q.numel() * q.element_size()
                          + lse.numel() * lse.element_size())
                main = {"max_abs_err": max(errs), "frobenius_rel": max(rels),
                        "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                        **bound(flop, nbytes), "library_ms": lib_ms,
                        "library_device_ms": lib_dev_ms}
                tflops = ("not measured" if dev_ms is None
                          else f"{flop / dev_ms / 1e9:.1f} TFLOP/s")
                log(f"[flash_bwd] bf16 main shape: device {fmt_ms(dev_ms)} "
                    f"({tflops}, {share(main['bound_ms'], dev_ms)} of the "
                    f"bound {main['bound_ms']:.4f} ms, {main['bound_by']}); "
                    f"F.scaled_dot_product_attention backward {lib_ms:.3f} "
                    f"ms per call, device {fmt_ms(lib_dev_ms)} "
                    f"({share(main['bound_ms'], lib_dev_ms)} of the bound)")
                del qr, kr, vr, lib_out
            del q, k, v, g, o, lse, args, out

    # FlashMHA end to end (forward and backward kernels) vs autograd
    # through the plain forward, fp32
    q, k, v, w = (torch.randn(BWD_SHAPE, device=dev, generator=gen) * s
                  for s in (0.125, 1.0, 1.0, 1.0))
    grads = []
    for fwd in (A.FlashMHA.apply, A.flash_mha_reference):
        xs = [x.detach().requires_grad_() for x in (q, k, v)]
        (fwd(*xs) * w).sum().backward()
        grads.append([x.grad for x in xs])
    torch.cuda.synchronize()
    err = max((a - r).abs().max().item() for a, r in zip(*grads))
    log(f"[flash_bwd] FlashMHA vs autograd through the plain forward, fp32 "
        f"{BWD_SHAPE}: max_abs_err {err:.3e} (atol/rtol {BWD_F32_TOL})")
    if not all(torch.allclose(a, r, atol=BWD_F32_TOL, rtol=BWD_F32_TOL)
               for a, r in zip(*grads)):
        raise AssertionError("FlashMHA gradients disagree with autograd")
    del q, k, v, w, grads
    torch.cuda.empty_cache()
    return main


def phase_ancestry(dev) -> dict:
    """Ancestry beam attention vs its plain version at the beam step's
    shapes: q/k_new/v_new (10, 20, 1, 64), one layer's cache (10, 20, T, 64),
    random group-local ancestors; L2 is warm (one layer's K/V <= 11.5 MB)."""
    from ts_asr_whisper_tpu_torch.ops import beam_attention as BA

    gen = torch.Generator(device=dev).manual_seed(4)
    bb, h = AUDIO_ROWS * BEAMS, TURBO["decoder_attention_heads"]
    main = {}
    for t in ANC_T:
        for pos in (1, t // 2, t - 1):
            for dt in (torch.bfloat16, torch.float32):
                q = torch.randn(bb, h, 1, 64, device=dev, generator=gen) / 8
                k_new, v_new = (torch.randn(bb, h, 1, 64, device=dev,
                                            generator=gen) for _ in range(2))
                ck, cv = (torch.randn(bb, h, t, 64, device=dev,
                                      generator=gen) for _ in range(2))
                hist = torch.randint(0, BEAMS, (bb, t), device=dev,
                                     generator=gen, dtype=torch.int32)
                args = [x.to(dt) for x in (q, k_new, v_new, ck, cv)] + [hist]
                out = BA.ancestry_attention(*args, pos, BEAMS)
                ref = BA.ancestry_attention_reference(*args, pos, BEAMS)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                atol, rtol = ANC_TOLS[dt]
                ok = out.dtype == dt and torch.allclose(
                    out.float(), ref.float(), atol=atol, rtol=rtol)
                ms = median_ms(lambda: BA.ancestry_attention(*args, pos,
                                                             BEAMS), reps=20)
                plain_ms = median_ms(
                    lambda: BA.ancestry_attention_reference(*args, pos, BEAMS),
                    reps=20)
                dev_ms = device_ms(
                    lambda: BA.ancestry_attention(*args, pos, BEAMS))
                plain_dev_ms = device_ms(
                    lambda: BA.ancestry_attention_reference(*args, pos, BEAMS))
                log(f"[ancestry] Bb {bb} H {h} T {t} pos {pos} "
                    f"{str(dt)[6:]}: max_abs_err {err:.3e} (atol {atol}, "
                    f"rtol {rtol}) per call: kernel {ms:.4f} ms plain "
                    f"{plain_ms:.4f} ms; device: kernel {fmt_ms(dev_ms)} "
                    f"plain {fmt_ms(plain_dev_ms)}")
                if not ok:
                    raise AssertionError(
                        f"ancestry kernel disagrees at T {t} pos {pos} {dt}")
                if (t, pos, dt) == ANC_MAIN:
                    # the K/V rows before pos of one layer's cache, the new
                    # K/V, q and out, the ancestor rows; ~1 FLOP per byte
                    item = args[0].element_size()
                    nbytes = (2 * bb * h * pos * 64 * item
                              + 4 * bb * h * 64 * item + bb * t * 4)
                    flop = 4 * bb * h * (pos + 1) * 64
                    main = {"max_abs_err": err, "ms": ms,
                            "plain_ms": plain_ms, "device_ms": dev_ms,
                            "plain_device_ms": plain_dev_ms,
                            **bound(flop, nbytes, dt), "library_ms": None}
    return main


def phase_psi(dev) -> dict:
    """The psi gather + dot vs its plain version at the beam step's shapes:
    posterior (2, 51867, 375) from blank-dominant CTC logits, 10 hypotheses
    x 512 candidate slots from the rescorer's own candidate rule on
    tie-heavy scores, weights w that span the frames. The sums are of
    positive terms, so they are held at a relative 2e-5 (a fixed atol would
    pass anything at sums of ~1e-6). Then the psi values it feeds
    (ctc_psi_candidates) on the card vs the CPU's plain path: same
    sparsity, live values at 2e-5. L2 is warm for the timings."""
    from ts_asr_whisper_tpu_torch.decoding.ctc_rescorer import candidate_mask
    from ts_asr_whisper_tpu_torch.models.config import DiCoWConfig
    from ts_asr_whisper_tpu_torch.ops import psi_gather as PG
    from ts_asr_whisper_tpu_torch.ops.ctc_prefix import (LOG_ZERO,
                                                         initial_ctc_state,
                                                         psi_weights)

    cfg = DiCoWConfig(**TURBO)
    v_dec, blank, eos = cfg.vocab_size, cfg.vocab_size, cfg.eos_token_id
    ts_begin = cfg.timestamp_begin
    # the rescorer's candidate count and slots: 500 -> 512 at turbo
    k = min(500, ts_begin - 1)
    k_pad = -(-(k + 1) // 128) * 128
    bb = AUDIO_ROWS * BEAMS
    gen = torch.Generator(device=dev).manual_seed(5)
    logits = torch.randn(AUDIO_ROWS, CTC_T, v_dec + 1, device=dev,
                         generator=gen) * 2
    logits[..., blank] += BLANK_LOGIT
    logp = torch.log_softmax(logits, dim=-1)
    del logits
    audio_idx = torch.arange(bb, device=dev) // BEAMS
    r0, _ = initial_ctc_state(logp, blank)
    r = r0[audio_idx]
    r = r + 0.1 * torch.randn(r.shape, device=dev, generator=gen)
    decoded_len = torch.randint(0, 4, (bb,), device=dev, generator=gen)
    decoded_len[0] = 0
    last = torch.randint(10, ts_begin, (bb,), device=dev, generator=gen)
    scores = torch.log_softmax(
        torch.randn(bb, v_dec, device=dev, generator=gen) * 3, dim=-1)
    scores[-1, 100:700] = scores[-1].max()    # 600 exact ties for 500 slots
    mask = candidate_mask(scores, k, eos, ts_begin)
    mask[1, last[1]] = True                   # the last-label correction
    popcount = int(mask.sum(dim=1).max())
    if popcount > k_pad:
        raise AssertionError(f"{popcount} candidates > {k_pad} slots")
    logp_vt = logp.transpose(1, 2).contiguous()
    x_last = logp_vt[audio_idx, last]
    ids = PG.extract_topk_ids(mask, k_pad)
    w, _, _ = psi_weights(r, decoded_len)
    span = int((w > 1e-3 * w.amax(dim=1, keepdim=True)).sum(dim=1).min())
    if span < W_SPAN:
        raise AssertionError(f"psi weights span {span} frames < {W_SPAN}: "
                             "the sums would not test every frame")
    cpu = [x.cpu() for x in (mask, audio_idx, x_last, r, decoded_len, last)]
    main = {}
    for dt in (torch.float32, torch.bfloat16):
        p_vt = PG.padded_posterior(torch.exp(logp_vt), dt)
        vals = PG.psi_gather_dot(p_vt, audio_idx, ids, w)
        ref = PG.psi_gather_dot_reference(p_vt, audio_idx, ids, w)
        torch.cuda.synchronize()
        err = (vals - ref).abs().max().item()
        rel = ((vals - ref).abs() / ref.abs().clamp_min(1e-30)).max().item()
        ok = torch.allclose(vals, ref, atol=0.0, rtol=PSI_TOL)
        psi = PG.ctc_psi_candidates(p_vt, mask, audio_idx, x_last, r,
                                    decoded_len, last, eos, k_pad).cpu()
        psi_ref = PG.ctc_psi_candidates(p_vt.cpu(), *cpu, eos, k_pad)
        live = psi_ref > LOG_ZERO / 2
        same_live = torch.equal(psi > LOG_ZERO / 2, live)
        psi_err = (psi[live] - psi_ref[live]).abs().max().item()
        ok = ok and same_live and torch.allclose(
            psi[live], psi_ref[live], atol=PSI_TOL, rtol=PSI_TOL)
        ms = median_ms(lambda: PG.psi_gather_dot(p_vt, audio_idx, ids, w),
                       reps=20)
        plain_ms = median_ms(
            lambda: PG.psi_gather_dot_reference(p_vt, audio_idx, ids, w),
            reps=20)
        dev_ms = device_ms(lambda: PG.psi_gather_dot(p_vt, audio_idx, ids, w))
        plain_dev_ms = device_ms(
            lambda: PG.psi_gather_dot_reference(p_vt, audio_idx, ids, w))
        log(f"[psi] P (2, {v_dec + 1}, {CTC_T}) {str(dt)[6:]}, ids "
            f"{tuple(ids.shape)}, popcount <= {popcount}: sums max_abs_err "
            f"{err:.3e} (sums {ref.min().item():.3e} to "
            f"{ref.max().item():.3e}, max rel err {rel:.3e}, rtol {PSI_TOL}; "
            f"w spans >= {span} of {CTC_T} frames), live psi max_abs_err {psi_err:.3e} vs the CPU path "
            f"({int(live.sum())} live, sparsity "
            f"{'equal' if same_live else 'DIFFERS'}; atol/rtol {PSI_TOL}) "
            f"per call: kernel {ms:.4f} ms plain {plain_ms:.4f} ms; device: "
            f"kernel {fmt_ms(dev_ms)} plain {fmt_ms(plain_dev_ms)}")
        if not ok:
            raise AssertionError(f"psi kernel disagrees ({dt})")
        if dt == torch.float32:
            # the gathered candidate rows (each read once), w, the sums
            nbytes = (ids.numel() * CTC_T * p_vt.element_size()
                      + w.numel() * 4 + vals.numel() * 4)
            flop = 2 * ids.numel() * CTC_T
            main = {"max_abs_err": err, "max_rel_err": rel, "ms": ms,
                    "plain_ms": plain_ms, "device_ms": dev_ms,
                    "plain_device_ms": plain_dev_ms,
                    **bound(flop, nbytes, dt), "library_ms": None}
        del p_vt
    del logp, logp_vt
    torch.cuda.empty_cache()
    return main


def _reorder_idx(kind: str, bb: int, gen) -> torch.Tensor:
    """One beam step's source rows: drawn with repeats within each group of
    BEAMS, the identity, or each group reversed."""
    base = torch.arange(bb, device=gen.device) // BEAMS * BEAMS
    if kind == "repeats":
        off = torch.randint(0, BEAMS, (bb,), device=gen.device, generator=gen)
        off[::BEAMS] = off[1::BEAMS]  # at least one repeat per group
    elif kind == "identity":
        off = torch.arange(bb, device=gen.device) % BEAMS
    else:
        off = BEAMS - 1 - torch.arange(bb, device=gen.device) % BEAMS
    return (base + off).to(torch.int32)


def phase_reorder(dev) -> dict:
    """The two KV-cache reorder kernels vs their plain versions, bit for bit
    (a copy: tolerance 0), then times at the beam step's shapes. The main
    shape is the decode's: (4, 10, 20, 128, 64) bf16, 13.1 MB, so L2 (50 MB)
    holds it between calls; at T 448 in fp32 (183.5 MB) it cannot. The bound
    counts the cache read once and written once, and idx."""
    from ts_asr_whisper_tpu_torch.ops import reorder as R

    gen = torch.Generator(device=dev).manual_seed(7)
    layers, h = TURBO["decoder_layers"], TURBO["decoder_attention_heads"]
    fns = {"bhtd": (R.reorder_bhtd, R.reorder_bhtd_reference, 1),
           "tbhd": (R.reorder_tbhd, R.reorder_tbhd_reference, 2)}
    main = {}
    for layout, (fn, ref_fn, dim) in fns.items():
        name = f"kv_reorder_{layout}"
        for t, bb in REORDER_CASES:
            for dt in (torch.bfloat16, torch.float32):
                shape = ((layers, bb, h, t, 64) if layout == "bhtd"
                         else (layers, t, bb, h, 64))
                cache = torch.randn(shape, device=dev,
                                    generator=gen).to(dt)
                errs = []
                for kind in REORDER_KINDS:
                    idx = _reorder_idx(kind, bb, gen)
                    out = fn(cache, idx)
                    ref = ref_fn(cache, idx)
                    torch.cuda.synchronize()
                    if not torch.equal(out, ref):
                        raise AssertionError(
                            f"{name} disagrees with its plain version "
                            f"at {shape} {dt} ({kind})")
                    errs.append((out.float() - ref.float()).abs().max()
                                .item())
                idx = _reorder_idx("repeats", bb, gen)
                ms = median_ms(lambda: fn(cache, idx), reps=50)
                dev_ms = device_ms(lambda: fn(cache, idx))
                plain_ms = median_ms(lambda: ref_fn(cache, idx), reps=50)
                lib_ms = median_ms(
                    lambda: torch.index_select(cache, dim, idx), reps=50)
                lib_dev_ms = device_ms(
                    lambda: torch.index_select(cache, dim, idx))
                nbytes = 2 * cache.numel() * cache.element_size() + bb * 4
                b = bound(0.0, nbytes, dt)
                log(f"[reorder] {layout} {tuple(shape)} {str(dt)[6:]}: "
                    f"equal bit for bit ({', '.join(REORDER_KINDS)}); "
                    f"per call: kernel {ms:.4f} ms plain {plain_ms:.4f} "
                    f"ms index_select {lib_ms:.4f} ms; device: kernel "
                    f"{fmt_ms(dev_ms)} index_select {fmt_ms(lib_dev_ms)}; "
                    f"bound {b['bound_ms']:.4f} ms ({nbytes / 1e6:.1f} "
                    f"MB)")
                if (t, bb, dt) == (*REORDER_CASES[0], torch.bfloat16):
                    main[name] = {"max_abs_err": max(errs), "ms": ms,
                                  "device_ms": dev_ms,
                                  "plain_ms": plain_ms, **b,
                                  "library_ms": lib_ms,
                                  "library_device_ms": lib_dev_ms}
                del cache
    torch.cuda.empty_cache()
    return main


def phase_encoder(dev) -> None:
    from ts_asr_whisper_tpu_torch.models.config import DiCoWConfig
    from ts_asr_whisper_tpu_torch.models.dicow import build_dicow

    cfg = DiCoWConfig(**TURBO, dtype="float32", use_pre_pos_fddt=True,
                      fddt_init="random")
    model = build_dicow(cfg, dev, seed=0, flash=True)
    enc = model.encoder
    gen = torch.Generator(device=dev).manual_seed(1)
    feats = torch.randn(2, 128, 3000, device=dev, generator=gen)
    labels = torch.randint(0, 4, (2, 1500), device=dev, generator=gen)
    stno = torch.nn.functional.one_hot(labels, 4).transpose(1, 2).float()
    with torch.no_grad():
        out = enc(feats, stno)
        enc.flash = False
        ref = enc(feats, stno)
        enc.flash = True
    torch.cuda.synchronize()
    if out.shape != (2, 1500, 1280) or not torch.isfinite(out).all():
        raise AssertionError(f"encoder output {tuple(out.shape)} not finite")
    err = (out - ref).abs().max().item()
    log(f"[encoder] turbo fp32, 2 windows: max_abs_err kernel vs plain "
        f"{err:.3e} (atol {ENC_ATOL}), output max |x| "
        f"{out.abs().max().item():.2f}")
    if err > ENC_ATOL:
        raise AssertionError("encoder: kernel and plain attention disagree")

    # bf16 encoder at decode batch 16: kernel vs plain attention
    model.to(torch.bfloat16)
    model.cfg = enc.cfg = cfg.replace(dtype="bfloat16")
    feats = torch.randn(16, 128, 3000, device=dev, generator=gen)
    stno = stno[:1].expand(16, -1, -1)
    with torch.no_grad():
        t_kernel = median_ms(lambda: enc(feats, stno), reps=3, warmup=1)
        enc.flash = False
        t_plain = median_ms(lambda: enc(feats, stno), reps=3, warmup=1)
    log(f"[encoder] turbo bf16, 16 windows: kernel {t_kernel:.1f} ms "
        f"({16e3 / t_kernel:.1f} windows/s), plain attention {t_plain:.1f} ms "
        f"({16e3 / t_plain:.1f} windows/s)")
    del model, enc, feats, out, ref
    torch.cuda.empty_cache()


def run_decode(dev, tag: str, overrides, durations) -> dict:
    """Drive the decode entry point (DecodeRunner) on a synthetic corpus at
    turbo width with random weights; the launch counts are set to 0 just
    before the run and read just after. Checks the output files, a finite
    tcp_wer, and that every encoder layer and every CTC-head call ran the
    flash kernel."""
    from ts_asr_whisper_tpu_torch import kernels
    from ts_asr_whisper_tpu_torch.config import load_config
    from ts_asr_whisper_tpu_torch.data.synthetic import write_corpus
    from ts_asr_whisper_tpu_torch.decode import DecodeRunner, scoring_backend
    from ts_asr_whisper_tpu_torch.decoding import beam
    from ts_asr_whisper_tpu_torch.models.dicow import DiCoWEncoder

    work = WORK / tag
    shutil.rmtree(work, ignore_errors=True)
    manifest = write_corpus(work / "corpus", durations, seed=0)
    model_dir = work / "model"
    model_dir.mkdir(parents=True)
    (model_dir / "config.json").write_text(json.dumps(TURBO))
    out_dir = work / "exp"
    cfg = load_config([
        *overrides,
        f"model.whisper_model={model_dir}",
        f"data.eval_cutsets=[{manifest}]",
        "training.generation_max_length=128",
        "training.save_visualizations=false",
        f"training.output_dir={out_dir}",
    ])
    t = cfg.training
    log(f"[{tag}] batch {t.per_device_eval_batch_size}, beams "
        f"{t.generation_num_beams}, decoding CTC weight "
        f"{cfg.decoding.decoding_ctc_weight}, length penalty "
        f"{cfg.decoding.length_penalty}, dtype {cfg.model.dtype}, max length "
        f"{t.generation_max_length}, timestamps {cfg.data.use_timestamps}")

    t0 = time.perf_counter()
    runner = DecodeRunner(cfg, dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    enc = runner.container.model.encoder
    calls = {"encoder": 0, "ctc_head": 0}

    def count_encoder(module, args, output):
        if isinstance(module, DiCoWEncoder):
            calls["encoder"] += 1

    ctc_logits = enc.ctc_logits

    def counted_ctc_logits(hidden):
        calls["ctc_head"] += 1
        return ctc_logits(hidden)

    enc.ctc_logits = counted_ctc_logits
    hook = torch.nn.modules.module.register_module_forward_hook(count_encoder)
    for name in kernels.launch_counts:
        kernels.launch_counts[name] = 0
    beam.counters["beam_steps"] = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        metrics = runner.run()
    finally:
        hook.remove()
        del enc.ctc_logits
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    steps = beam.counters["beam_steps"]

    name = "eval_cutset"
    csv_path = out_dir / f"test_{name}" / "step_0" / "all_session_wer.csv"
    hyps = list((out_dir / f"test_{name}").rglob("tcp_wer_hyp.json"))
    tcp = metrics.get(f"eval_{name}_tcp_wer")
    rows = len(runner.eval_datasets[name])
    audio_s = 2 * sum(durations)  # two target speakers per recording
    log(f"[{tag}] {rows} rows, {runner.windows_decoded} row-windows, "
        f"{calls['encoder']} encoder calls, {calls['ctc_head']} CTC-head "
        f"calls, {steps} beam steps, wall {wall:.1f} s "
        f"(+{setup_s:.1f} s model/data set-up), "
        f"{audio_s / wall:.1f} audio-s/s, "
        f"{runner.windows_decoded / wall:.2f} row-windows/s, "
        f"launches {launches}, peak mem "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB, "
        f"scoring {scoring_backend()}")
    log(f"[{tag}] metrics {metrics}")
    if not csv_path.exists() or len(hyps) != len(durations):
        raise AssertionError(f"{tag} outputs missing: {csv_path}, "
                             f"{len(hyps)} hypothesis files")
    if tcp is None or not math.isfinite(tcp):
        raise AssertionError(f"{tag}: no finite tcp_wer in {metrics}")
    if scoring_backend() != "native":
        from ts_asr_whisper_tpu_torch.eval import native

        raise AssertionError(f"{tag}: scored with the numpy fallback; "
                             f"native build: {native.build_log}")
    if rows != 2 * len(durations) or calls["encoder"] == 0:
        raise AssertionError(f"{tag}: {rows} rows, {calls['encoder']} "
                             "encoder calls")
    # every encoder layer's self-attention, every SCB's cross-attention
    # (SE-DiCoW) and the CTC head's bare self-attention run the kernel
    mc = runner.container.model_config
    per_call = mc.encoder_layers + (mc.scb_layers or 0) * mc.use_enrollments
    want = per_call * calls["encoder"] + calls["ctc_head"]
    if launches["flash_attn_fwd"] != want:
        raise AssertionError(
            f"{tag}: flash_attn_fwd launched {launches['flash_attn_fwd']} "
            f"times, want {want} ({per_call} x encoder calls + CTC-head "
            "calls)")
    return {"runner": runner, "launches": launches, "steps": steps,
            "calls": calls, "wall": wall}


def phase_decode(dev) -> dict:
    res = run_decode(dev, "greedy", ["+decode=dicow_v3_greedy"], [60.0] * 8)
    if any(res["launches"][k] for k in ("ancestry_attn", "psi_gather_dot",
                                        "kv_reorder_bhtd", "kv_reorder_tbhd")):
        raise AssertionError(f"greedy decode ran beam kernels: "
                             f"{res['launches']}")
    phase_decode_loop(res["runner"], dev)
    return res["launches"]


def phase_decode_loop(runner, dev, steps: int = 125) -> None:
    """The greedy loop alone at batch 16, run to full length (no EOS exit)
    on random encoder states: ms per decode step, cross-KV included."""
    from ts_asr_whisper_tpu_torch.decoding.greedy import greedy_decode

    model = runner.container.model
    gen = torch.Generator(device=dev).manual_seed(2)
    enc = torch.randn(16, 1500, TURBO["d_model"], device=dev,
                      generator=gen).to(runner.container.model_config
                                        .compute_dtype)
    prompt = torch.tensor(runner.container.tokenizer.prefix_tokens[:3],
                          device=dev).repeat(16, 1)
    for _ in range(2):  # the first pass warms the allocator
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        greedy_decode(model, runner.gen_cfg, enc, prompt, steps,
                      force_full_length=True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    log(f"[decode] greedy loop alone, batch 16, {steps} steps to full "
        f"length: {dt * 1e3 / steps:.2f} ms/step ({dt:.2f} s)")
    del model, enc


def run_beam_decode(dev, tag: str, overrides, durations) -> dict:
    """A beam joint-CTC decode through the decode entry point (run_decode);
    the time inside beam_search (prefill and cross-KV included) gives ms per
    beam step. Checks that it was a beam joint-CTC decode whose every beam
    step launched the psi kernel once."""
    from ts_asr_whisper_tpu_torch.decoding import ctc_rescorer
    from ts_asr_whisper_tpu_torch.decoding import longform
    from ts_asr_whisper_tpu_torch.models.whisper import get_kv_cache_layout
    from ts_asr_whisper_tpu_torch.ops.reorder import get_reorder_impl

    beam_search = longform.beam_search
    beam_s = [0.0]

    def timed_beam_search(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = beam_search(*args, **kwargs)
        torch.cuda.synchronize()
        beam_s[0] += time.perf_counter() - t0
        return out

    gc.collect()  # the models of the phases before
    torch.cuda.empty_cache()
    longform.beam_search = timed_beam_search
    try:
        res = run_decode(dev, tag, overrides, durations)
    finally:
        longform.beam_search = beam_search
    steps, launches = res["steps"], res["launches"]
    gen_cfg = res["runner"].gen_cfg
    res["ms_per_step"] = beam_s[0] * 1e3 / max(steps, 1)
    log(f"[{tag}] {steps} beam steps in {beam_s[0]:.2f} s of "
        f"beam_search: {res['ms_per_step']:.2f} ms per beam step (Bb "
        f"{AUDIO_ROWS * BEAMS}), reorder impl {get_reorder_impl(device=dev)},"
        f" cache layout {get_kv_cache_layout()}, psi path "
        f"{ctc_rescorer.resolve_psi_impl(gen_cfg.ctc_psi_impl, dev)}")
    if gen_cfg.num_beams != BEAMS or not gen_cfg.ctc_weight > 0:
        raise AssertionError(f"{tag}: not a beam joint-CTC decode: {gen_cfg}")
    if steps == 0 or res["calls"]["ctc_head"] == 0:
        raise AssertionError(f"{tag}: {steps} beam steps, "
                             f"{res['calls']['ctc_head']} CTC-head calls")
    if launches["psi_gather_dot"] != steps:
        raise AssertionError(f"{tag}: psi_gather_dot launched "
                             f"{launches['psi_gather_dot']} times, want "
                             f"{steps} (one per beam step)")
    return res


def phase_beam_decode(dev) -> dict:
    """dicow_v3_beam_joint on the default ('auto': the ancestry cache on the
    card) reorder path: the ancestry kernel in every decoder layer of every
    beam step, no reorder kernel."""
    res = run_beam_decode(dev, "beam_joint", ["+decode=dicow_v3_beam_joint",
                                              "model.ctc_weight=0.3"],
                          [60.0] * 4)
    steps, launches = res["steps"], res["launches"]
    layers = TURBO["decoder_layers"]
    if launches["kv_reorder_bhtd"] or launches["kv_reorder_tbhd"]:
        raise AssertionError(f"beam_joint: the ancestry path ran a reorder "
                             f"kernel: {launches}")
    if launches["ancestry_attn"] != layers * steps:
        raise AssertionError(f"ancestry_attn launched "
                             f"{launches['ancestry_attn']} times, want "
                             f"{layers * steps} ({layers} layers x {steps} "
                             "beam steps)")
    return res


SE_DICOW = ["+decode=se_dicow_beam_joint", f"model.scb_layers={SCB_LAYERS}",
            "model.use_enrollments=true", "data.use_enrollments=true",
            "data.enrollment_cutsets=[]", "model.ctc_weight=0.3"]


def phase_se_dicow(dev, layout: str, durations) -> dict:
    """se_dicow_beam_joint with self-enrollment (no enrollment cutsets: each
    row's enrollment is the 30 s of its recording where its speaker talks
    most) through the decode entry point, with the standalone-permute
    reorder ('pallas') on the ``layout`` cache: the layout's reorder kernel
    twice per beam step (k and v), the other reorder kernel and the ancestry
    kernel never. The reorder impl and the cache layout are restored."""
    from ts_asr_whisper_tpu_torch.models import whisper as W
    from ts_asr_whisper_tpu_torch.ops import reorder as R

    tag = f"se_dicow_beam_joint_{layout}"
    prev = (R.get_reorder_impl(raw=True), W.get_kv_cache_layout())
    R.set_reorder_impl("pallas")
    W.set_kv_cache_layout(layout)
    try:
        res = run_beam_decode(dev, tag, SE_DICOW, durations)
    finally:
        R.set_reorder_impl(prev[0])
        W.set_kv_cache_layout(prev[1])
    steps, launches = res["steps"], res["launches"]
    mc = res["runner"].container.model_config
    if not (mc.use_enrollments and mc.scb_layers == SCB_LAYERS) or len(
            res["runner"].container.model.encoder.ca_enrolls) != SCB_LAYERS:
        raise AssertionError(f"{tag}: not an SE-DiCoW model with "
                             f"{SCB_LAYERS} SCBs")
    other = "tbhd" if layout == "bhtd" else "bhtd"
    want = {f"kv_reorder_{layout}": 2 * steps, f"kv_reorder_{other}": 0,
            "ancestry_attn": 0}
    got = {k: launches[k] for k in want}
    log(f"[{tag}] encoder calls {res['calls']['encoder']} (each "
        f"{mc.encoder_layers} layers + {SCB_LAYERS} SCBs on 2 streams), "
        f"launches {got}, want {want}")
    if got != want:
        raise AssertionError(f"{tag}: launches {got}, want {want}")
    return res


def _snapshot(model) -> dict:
    return {n: p.detach().to("cpu", copy=True)
            for n, p in model.named_parameters()}


def _changed(a: dict, b: dict) -> set:
    return {n for n in a if not torch.equal(a[n], b[n])}


def phase_train(dev) -> dict:
    """+train=dicow_v3 through ModelTrainer, as the CLI drives it, on a
    synthetic corpus at turbo width with random weights. The launch counts
    are set to 0 just before the run and read just after."""
    from safetensors.torch import load_file

    from ts_asr_whisper_tpu_torch import kernels
    from ts_asr_whisper_tpu_torch.config import load_config
    from ts_asr_whisper_tpu_torch.data.synthetic import write_corpus
    from ts_asr_whisper_tpu_torch.models.containers import WhisperContainer
    from ts_asr_whisper_tpu_torch.models.convert import normalize_state_dict
    from ts_asr_whisper_tpu_torch.train import ModelTrainer
    from ts_asr_whisper_tpu_torch.training import trainer as trainer_mod

    gc.collect()  # the decode phases' models
    torch.cuda.empty_cache()
    work = WORK / "train"
    shutil.rmtree(work, ignore_errors=True)
    manifest = write_corpus(work / "corpus", [30.0] * 8, seed=1)
    model_dir = work / "model"
    model_dir.mkdir(parents=True)
    (model_dir / "config.json").write_text(json.dumps(TURBO))
    out_dir = work / "exp"
    cfg = load_config([
        "+train=dicow_v3", f"model.whisper_model={model_dir}",
        "model.reinit_encoder_from=null", f"data.train_cutsets=[{manifest}]",
        "data.dev_cutsets=[]", "data.eval_cutsets=[]",
        "data.dataset_weights=null", "aug.musan_root=null",
        "training.overall_batch_size=8",
        "training.gradient_accumulation_steps=2", "training.max_steps=8",
        "training.use_fddt_only_n_steps=4", "training.warmup_steps=0",
        "training.eval_strategy=no", "training.save_strategy=no",
        "training.logging_steps=1", f"training.output_dir={out_dir}"])
    t = cfg.training
    k = t.gradient_accumulation_steps
    t0 = time.perf_counter()
    mt = ModelTrainer(cfg, dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    model, mc = mt.model, mt.container.model_config
    # flash calls per micro-batch: every encoder layer's self-attention and
    # the CTC head's bare self-attention (q_len = kv_len = 1500, no mask);
    # the decoder's attention is masked or cross, so it stays plain
    per_batch = mc.encoder_layers + int(
        mc.ctc_weight > 0 and (mc.additional_layer
                               or mc.additional_self_attention_layer))
    log(f"[train] dicow_v3: {len(mt.train_dataset)} rows, micro-batch "
        f"{t.per_device_train_batch_size}, accumulation {k}, "
        f"{t.max_steps} micro-batches ({t.use_fddt_only_n_steps} preheat), "
        f"dtype {mc.dtype} params {cfg.model.param_dtype}, CTC weight "
        f"{mc.ctc_weight}, gradient checkpointing "
        f"{t.gradient_checkpointing}, {per_batch} flash calls per "
        f"micro-batch; set-up {setup_s:.1f} s")

    snaps = {"start": _snapshot(model)}
    phase_labels = {}
    unfreeze = trainer_mod.Trainer._maybe_unfreeze

    def watched_unfreeze(self):
        phase = self.state.phase
        if phase == "preheat":
            phase_labels["preheat"] = dict(self.labels)
        unfreeze(self)
        if phase == "preheat" and self.state.phase == "base":
            torch.cuda.synchronize()
            snaps["preheat"] = _snapshot(self.model)
            phase_labels["base"] = dict(self.labels)

    train_loop = trainer_mod.Trainer.train
    loop_s = []

    def timed_loop(self, it):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = train_loop(self, it)
        torch.cuda.synchronize()
        loop_s.append(time.perf_counter() - t1)
        return out

    trainer_mod.Trainer._maybe_unfreeze = watched_unfreeze
    trainer_mod.Trainer.train = timed_loop
    for name in kernels.launch_counts:
        kernels.launch_counts[name] = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        mt.train()
    finally:
        trainer_mod.Trainer._maybe_unfreeze = unfreeze
        trainer_mod.Trainer.train = train_loop
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    peak = torch.cuda.max_memory_allocated() / 2**30
    snaps["end"] = _snapshot(model)

    recs = [json.loads(line) for line in
            (out_dir / "metrics.jsonl").read_text().splitlines()]
    losses = [r["loss"] for r in recs]
    updates = t.max_steps // k
    loop = loop_s[0]
    log(f"[train] {t.max_steps} micro-batches, {updates} updates: training "
        f"loop {loop:.2f} s, {loop * 1e3 / updates:.0f} ms per optimizer "
        f"update, {loop / t.max_steps * 1e3:.0f} ms per micro-batch of "
        f"{t.per_device_train_batch_size} (first steps' warm-up and data "
        f"loading included); ModelTrainer.train {wall:.1f} s with the HF "
        f"export; peak mem {peak:.1f} GiB; launches {launches}")
    log(f"[train] losses {[round(x, 4) for x in losses]}, grad norms "
        f"{[round(r['grad_norm'], 4) for r in recs]}")
    if len(recs) != t.max_steps or not all(
            math.isfinite(r[key]) for r in recs
            for key in ("loss", "dec_loss", "ctc_loss", "grad_norm")):
        raise AssertionError(f"train: {len(recs)} logged steps, not all "
                             f"finite: {recs}")
    want = per_batch * t.max_steps
    if not launches["flash_attn_fwd"] == launches["flash_attn_bwd"] == want:
        raise AssertionError(
            f"train: flash launches fwd {launches['flash_attn_fwd']} bwd "
            f"{launches['flash_attn_bwd']}, want {want} ({per_batch} x "
            f"{t.max_steps} micro-batches)")
    if set(phase_labels) != {"preheat", "base"}:
        raise AssertionError(f"train: phases seen {sorted(phase_labels)}")
    pre = {n for n, lab in phase_labels["preheat"].items()
           if lab == "preheat"}
    changed = _changed(snaps["start"], snaps["preheat"])
    if not changed or not changed <= pre:
        raise AssertionError(f"preheat changed {len(changed)} tensors, "
                             f"{sorted(changed - pre)[:5]} outside the "
                             f"{len(pre)} preheat tensors")
    changed = _changed(snaps["preheat"], snaps["end"])
    dec = {n for n in snaps["end"] if ".decoder." in n}
    base = {n for n, lab in phase_labels["base"].items() if lab == "base"}
    if changed & dec or not changed & base:
        raise AssertionError(f"base phase changed {len(changed & dec)} "
                             f"decoder tensors, {len(changed & base)} base "
                             "tensors")
    log(f"[train] preheat changed {len(_changed(snaps['start'], snaps['preheat']))}"
        f" of {len(pre)} preheat tensors and nothing else; base changed "
        f"{len(changed)} tensors ({len(changed & base)} base), decoder "
        f"({len(dec)} tensors) bit-identical")

    # the export loads strictly into the port's container and equals the
    # trained parameters
    del mt, model
    gc.collect()
    torch.cuda.empty_cache()
    export = out_dir / "hf_export"
    ecfg = load_config([f"model.whisper_model={export}",
                               "model.ctc_weight=0.3"])
    container = WhisperContainer(ecfg, dev)
    sd = normalize_state_dict(load_file(str(export / "model.safetensors")))
    loaded = dict(container.model.named_parameters())
    bad = [n for n, v in snaps["end"].items()
           if not torch.equal(loaded[n].detach().cpu(), v)]
    log(f"[train] hf_export: {len(sd)} tensors, loaded strictly into the "
        f"port's container, {len(loaded) - len(bad)} of {len(loaded)} "
        "parameters equal to the trained ones")
    if bad:
        raise AssertionError(f"hf_export differs from the trained model: "
                             f"{bad[:5]}")
    del container, snaps
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "ms_per_update": loop * 1e3 / updates,
            "peak_gib": peak}


def main() -> int:
    kind = phase_card()
    dev = torch.device("cuda", 0)
    phase_build()
    k_flash = phase_kernel(dev)
    k_bwd = phase_flash_bwd(dev)
    k_anc = phase_ancestry(dev)
    k_psi = phase_psi(dev)
    k_reorder = phase_reorder(dev)
    phase_encoder(dev)
    paths = {"dicow_v3_greedy": phase_decode(dev),
             "dicow_v3_beam_joint": phase_beam_decode(dev)["launches"],
             "dicow_v3_train": phase_train(dev)["launches"],
             "se_dicow_beam_joint": phase_se_dicow(
                 dev, "bhtd", [60.0] * 2)["launches"],
             "se_dicow_beam_joint_tbhd": phase_se_dicow(
                 dev, "tbhd", [60.0])["launches"]}
    from ts_asr_whisper_tpu_torch.kernels import KERNEL_SOURCES

    csrc = "ts_asr_whisper_tpu_torch/kernels/csrc"
    replaces = {"flash_attn_fwd": "ts_asr_whisper_tpu/ops/attention.py:84",
                "flash_attn_bwd": "ts_asr_whisper_tpu/ops/attention.py:178",
                "ancestry_attn": "ts_asr_whisper_tpu/ops/beam_attention.py:110",
                "psi_gather_dot": "ts_asr_whisper_tpu/ops/psi_gather.py:125",
                "kv_reorder_bhtd": "ts_asr_whisper_tpu/ops/reorder.py:36",
                "kv_reorder_tbhd": "ts_asr_whisper_tpu/ops/reorder.py:64"}
    timing = {"flash_attn_fwd": k_flash, "flash_attn_bwd": k_bwd,
              "ancestry_attn": k_anc, "psi_gather_dot": k_psi, **k_reorder}
    record = {"kernels": [{
        "name": name, "route": "cuda",
        "source": f"{csrc}/{KERNEL_SOURCES[name]}.cu",
        "replaces": replaces[name],
        "launches": sum(launches[name] for launches in paths.values()),
        "launches_by_path": {path: launches[name]
                             for path, launches in paths.items()},
        **timing[name]} for name in KERNELS]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
