#!/usr/bin/env python
"""Smoke run of the PyTorch port (ts_asr_whisper_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it breaks:
  1. the card: nvidia-smi name and power limit, torch and CUDA versions;
     no CUDA device -> exit 2, there is no CPU path;
  2. build the CUDA flash-attention kernel from kernels/csrc with nvcc;
  3. kernel vs its plain PyTorch version at the encoder's shapes, bf16 and
     fp32, with errors and median times (CUDA events, after warm-up);
  4. the large-v3-turbo DiCoW encoder at fp32 on 2 windows, through the
     kernel and through plain attention;
  5. long-form greedy decode of a synthetic 16-row corpus (8 two-speaker
     recordings of 60 s) at large-v3-turbo width with random weights,
     through the decode entry point with the dicow_v3_greedy settings;
     every encoder layer must have run the kernel.
The line before the last is a JSON record of the kernels; the last line is
{"ok": true, "device": {...}}. Nothing here imports jax.
"""

from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

sys.modules["jax"] = None  # the port must never reach jax

import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
TURBO = {"vocab_size": 51866, "num_mel_bins": 128, "d_model": 1280,
         "encoder_layers": 32, "decoder_layers": 4,
         "encoder_attention_heads": 20, "decoder_attention_heads": 20,
         "encoder_ffn_dim": 5120, "decoder_ffn_dim": 5120,
         "max_source_positions": 1500, "max_target_positions": 448}
ENC_SHAPE = (16, 20, 1500, 64)   # turbo encoder attention at batch 16
RAGGED_T = (257, 1000, 1499)
TOLS = {torch.float32: (2e-5, 1e-5),   # as tests/test_attention.py
        torch.bfloat16: (1e-2, 1e-2)}  # bf16 rounding of p and out dominates
# fp32 encoder, kernel vs plain attention: both fp32 with no TF32; the only
# difference is summation order (~1e-6 per attention), carried through 32
# residual layers and the FDDTs of a random-weight model
ENC_ATOL = 1e-3


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

    t0 = time.perf_counter()
    kernels.flash_attn_fwd_lib()
    info = kernels.build_info["flash_attn_fwd"]
    log(f"[build] flash_attn_fwd.cu -> sm_90a in {info['seconds']:.1f} s "
        f"(load {time.perf_counter() - t0:.1f} s)")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build]   {line.strip()}")


def phase_kernel(dev) -> dict:
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
        out = A.flash_mha_fwd(q, k, v)
        ref = A.flash_mha_reference(q, k, v)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        atol, rtol = TOLS[dt]
        ok = torch.allclose(out.float(), ref.float(), atol=atol, rtol=rtol)
        ms = median_ms(lambda: A.flash_mha_fwd(q, k, v))
        plain_ms = median_ms(lambda: A.flash_mha_reference(q, k, v), reps=5)
        flop = 4 * shape[0] * shape[1] * shape[2] ** 2 * shape[3]
        log(f"[kernel] {tuple(shape)} {str(dt)[6:]}: max_abs_err {err:.3e} "
            f"(atol {atol}, rtol {rtol}) kernel {ms:.3f} ms "
            f"({flop / ms / 1e9:.1f} TFLOP/s) plain {plain_ms:.3f} ms")
        if not ok:
            raise AssertionError(f"kernel disagrees at {shape} {dt}")
        if shape == ENC_SHAPE and dt == torch.bfloat16:
            main = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        del q, k, v, out, ref
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


def phase_decode(dev) -> dict:
    from ts_asr_whisper_tpu_torch.data.synthetic import write_corpus
    from ts_asr_whisper_tpu_torch.decode import (DecodeRunner,
                                                 load_decode_config,
                                                 scoring_backend)
    from ts_asr_whisper_tpu_torch.models.dicow import DiCoWEncoder
    from ts_asr_whisper_tpu_torch.ops import attention as A

    shutil.rmtree(WORK, ignore_errors=True)
    durations = [60.0] * 8
    manifest = write_corpus(WORK / "corpus", durations, seed=0)
    model_dir = WORK / "model"
    model_dir.mkdir(parents=True)
    (model_dir / "config.json").write_text(json.dumps(TURBO))
    out_dir = WORK / "exp"
    cfg = load_decode_config([
        "+decode=dicow_v3_greedy",
        f"model.whisper_model={model_dir}",
        f"data.eval_cutsets=[{manifest}]",
        "training.generation_max_length=128",
        "training.save_visualizations=false",
        f"training.output_dir={out_dir}",
    ])
    t = cfg.training
    log(f"[decode] batch {t.per_device_eval_batch_size}, beams "
        f"{t.generation_num_beams}, dtype {cfg.model.dtype}, max length "
        f"{t.generation_max_length}, timestamps {cfg.data.use_timestamps}")

    encoder_calls = [0]

    def count(module, args, output):
        if isinstance(module, DiCoWEncoder):
            encoder_calls[0] += 1

    t0 = time.perf_counter()
    runner = DecodeRunner(cfg, dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    hook = torch.nn.modules.module.register_module_forward_hook(count)
    for name in A.launch_counts:
        A.launch_counts[name] = 0
    t0 = time.perf_counter()
    try:
        metrics = runner.run()
    finally:
        hook.remove()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(A.launch_counts)

    name = "eval_cutset"
    csv_path = out_dir / f"test_{name}" / "step_0" / "all_session_wer.csv"
    hyps = list((out_dir / f"test_{name}").rglob("tcp_wer_hyp.json"))
    tcp = metrics.get(f"eval_{name}_tcp_wer")
    rows = len(runner.eval_datasets[name])
    audio_s = 2 * sum(durations)  # two target speakers per recording
    log(f"[decode] {rows} rows, {runner.windows_decoded} row-windows, "
        f"{encoder_calls[0]} encoder calls, wall {wall:.1f} s "
        f"(+{setup_s:.1f} s model/data set-up), "
        f"{audio_s / wall:.1f} audio-s/s, "
        f"{runner.windows_decoded / wall:.2f} row-windows/s, "
        f"flash_attn_fwd launches {launches['flash_attn_fwd']}, "
        f"peak mem {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB, "
        f"scoring {scoring_backend()}")
    log(f"[decode] metrics {metrics}")
    if not csv_path.exists() or len(hyps) != len(durations):
        raise AssertionError(f"decode outputs missing: {csv_path}, "
                             f"{len(hyps)} hypothesis files")
    if tcp is None or not math.isfinite(tcp):
        raise AssertionError(f"no finite tcp_wer in {metrics}")
    if rows != 16 or encoder_calls[0] == 0:
        raise AssertionError(f"{rows} rows, {encoder_calls[0]} encoder calls")
    want = TURBO["encoder_layers"] * encoder_calls[0]
    if launches["flash_attn_fwd"] != want:
        raise AssertionError(f"flash_attn_fwd launched "
                             f"{launches['flash_attn_fwd']} times, want "
                             f"{want} (32 x encoder calls)")
    phase_decode_loop(runner, dev)
    return launches


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


def main() -> int:
    kind = phase_card()
    dev = torch.device("cuda", 0)
    phase_build()
    k = phase_kernel(dev)
    phase_encoder(dev)
    launches = phase_decode(dev)
    record = {"kernels": [{
        "name": "flash_attn_fwd", "route": "cuda",
        "source": "ts_asr_whisper_tpu_torch/kernels/csrc/flash_attn_fwd.cu",
        "replaces": "ts_asr_whisper_tpu/ops/attention.py:84",
        "launches": launches["flash_attn_fwd"],
        "max_abs_err": k["max_abs_err"], "ms": k["ms"],
        "plain_ms": k["plain_ms"]}]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
