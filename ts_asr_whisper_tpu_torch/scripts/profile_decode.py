"""Decode timing decomposition on the card (or the CPU with --device cpu).

Counterpart of scripts/profile_decode.py. Times each stage of the
long-form pipeline separately (mel, window slicing, encoder, greedy loop,
beam-joint loop with and without CTC and the rescore share) plus the end-to-
end ``longform_generate`` with the device-stage estimate, so a regression can
be attributed to a stage. Wall time is the host clock around work that ends
in a device barrier (``utils/device.py::force_execution``); beside it each
stage prints its device time (``utils/devicetime.py::measure_device_ms``, one
further call) and the idle share of the card over the stage, 1 - device /
wall. Random weights from seed 0, synthetic audio from numpy's seed 0.

    python -m ts_asr_whisper_tpu_torch.scripts.profile_decode [--batch 16]
        [--beam-batch 8] [--beams 5] [--max-new 128]
        [--model large-v3-turbo] [--reorder pallas] [--topk thresholded]
        [--kv-layout tbhd] [--device cuda|cuda:N|cpu]

The last line but one lists the kernel launches of the whole run.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from .. import kernels
from ..decoding.beam import beam_search
from ..decoding.ctc_rescorer import CTCRescorer, init_ctc_state
from ..decoding.generation_config import GenerationConfig
from ..decoding.greedy import greedy_decode
from ..decoding.longform import longform_generate, slice_windows
from ..models.config import make_config
from ..models.dicow import build_dicow
from ..ops.mel import log_mel_spectrogram
from ..utils.device import force_execution
from ..utils.devicetime import measure_device_ms

PROMPT = [50258, 50259, 50360]


def timeit(fn, iters=3, warmup=1):
    for _ in range(warmup):
        force_execution(fn())
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    force_execution(out)
    return (time.perf_counter() - t0) / iters


def device_part(fn, wall_s: float) -> str:
    """The stage's device ms (one further call) and the card's idle share
    over its wall time; 'not measured' off the card."""
    dev_ms = measure_device_ms(fn, reps=1, warmup=0)
    if dev_ms is None:
        return "  device not measured"
    return (f"  device {dev_ms:8.1f} ms "
            f"({100 * (1 - dev_ms / (wall_s * 1e3)):.0f}% idle)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--beam-batch", type=int, default=8)
    ap.add_argument("--beams", type=int, default=5)
    ap.add_argument("--max-new", type=int, default=128)
    ap.add_argument("--model", default="large-v3-turbo")
    ap.add_argument("--reorder", default=None,
                    help="beam KV reorder strategy (ops/reorder.py)")
    ap.add_argument("--topk", default=None,
                    help="beam candidate top-k impl (ops/topk.py)")
    ap.add_argument("--kv-layout", default=None,
                    help="KV cache layout (models/whisper.py)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), cuda:N or cpu")
    args = ap.parse_args(argv)

    from ..__main__ import resolve_device
    from ..decode import no_tf32

    dev = resolve_device(args.device)
    no_tf32()
    if args.reorder:
        from ..ops.reorder import set_reorder_impl
        set_reorder_impl(args.reorder)
    if args.topk:
        from ..ops.topk import set_topk_impl
        set_topk_impl(args.topk)
    if args.kv_layout:
        from ..models.whisper import set_kv_cache_layout
        set_kv_cache_layout(args.kv_layout)

    cfg = make_config(args.model, ctc_weight=0.3, use_fddt=True,
                      use_pre_pos_fddt=True, non_target_fddt_value=0.5,
                      dtype="bfloat16")
    model = build_dicow(cfg, dev, seed=0, flash=True, dtype=torch.bfloat16)
    print(f"device: {dev} "
          f"{torch.cuda.get_device_name(dev) if dev.type == 'cuda' else ''}"
          f"; model {args.model} bf16, random weights", flush=True)

    b = args.batch
    n_windows = 3
    t_total = 3000 * n_windows
    rng = np.random.default_rng(0)
    audio = rng.standard_normal((b, 160 * t_total)).astype(np.float32) * 0.05

    # --- mel ---
    audio_dev = torch.from_numpy(audio).to(dev)

    def mel_fn():
        return log_mel_spectrogram(audio_dev, cfg.num_mel_bins)

    t_mel = timeit(mel_fn)
    print(f"mel (batch {b}, {n_windows * 30}s):      {t_mel * 1e3:8.1f} ms"
          + device_part(mel_fn, t_mel), flush=True)

    feats = mel_fn()
    feats_dev = torch.nn.functional.pad(feats.float(), (0, 3000))
    stno_dev = torch.nn.functional.pad(
        torch.full((b, 4, t_total // 2), 0.25, device=dev), (0, 1500))
    meta = np.stack([np.arange(b), np.zeros(b, np.int64),
                     np.full(b, 3000), np.full(b, 1500)])

    def slice_fn():
        return slice_windows(feats_dev, stno_dev, meta, nsf=3000)

    t_slice = timeit(slice_fn)
    print(f"window slice (batch {b}):    {t_slice * 1e3:8.1f} ms"
          + device_part(slice_fn, t_slice), flush=True)

    window, stno_w = slice_fn()

    def enc_fn():
        with torch.no_grad():
            return model.encoder(window, stno_w)

    t_enc = timeit(enc_fn)
    print(f"encoder (batch {b}):         {t_enc * 1e3:8.1f} ms"
          + device_part(enc_fn, t_enc), flush=True)
    enc = enc_fn()

    gen = GenerationConfig(return_timestamps=True, max_length=448)
    prompts = torch.tensor([PROMPT], device=dev).repeat(b, 1)

    def greedy_fn():
        return greedy_decode(model, gen, enc, prompts, args.max_new,
                             force_full_length=True)

    t_greedy = timeit(greedy_fn)
    print(f"greedy loop {args.max_new} tok (b{b}):  {t_greedy * 1e3:8.1f} ms"
          f"  ({t_greedy / args.max_new * 1e3:.2f} ms/tok)"
          + device_part(greedy_fn, t_greedy), flush=True)

    # --- beam-joint pieces at the beam envelope ---
    bb = args.beam_batch
    enc_b = enc[:bb]
    prompts_b = prompts[:bb]
    gen_beam = GenerationConfig(return_timestamps=True, max_length=448,
                                num_beams=args.beams, ctc_weight=0.2,
                                length_penalty=0.1)

    def beam_plain():
        return beam_search(model, gen_beam, enc_b, prompts_b, args.max_new,
                           num_beams=args.beams)

    t_beam_plain = timeit(beam_plain)
    print(f"beam-{args.beams} loop no-CTC (b{bb}): "
          f"{t_beam_plain * 1e3:8.1f} ms"
          + device_part(beam_plain, t_beam_plain), flush=True)

    with torch.no_grad():
        enc_logits = model.encoder.ctc_logits(enc_b)
    blank = cfg.ctc_vocab_size - 1
    scorer = CTCRescorer(blank_id=blank, eos_id=gen_beam.eos_token_id,
                         timestamp_begin=gen_beam.timestamp_begin,
                         ctc_weight=0.2,
                         k=min(500, gen_beam.timestamp_begin - 1),
                         prefix_len=len(PROMPT))

    def beam_joint():
        state = init_ctc_state(enc_logits, blank, None,
                               num_beams=args.beams, k=scorer.k)
        return beam_search(model, gen_beam, enc_b, prompts_b, args.max_new,
                           num_beams=args.beams, ctc_scorer=scorer,
                           ctc_state=state)

    t_beam_joint = timeit(beam_joint)
    print(f"beam-{args.beams} loop +CTC (b{bb}):  {t_beam_joint * 1e3:8.1f} ms"
          f"  (rescore share {100 * (1 - t_beam_plain / t_beam_joint):.0f}%)"
          + device_part(beam_joint, t_beam_joint), flush=True)

    # --- end-to-end longform (greedy) ---
    feats_np = feats.float().cpu().numpy()
    stno_np = np.full((b, 4, t_total // 2), 0.25, np.float32)
    attn = np.ones((b, t_total), np.int64)
    prompts_np = np.tile(np.asarray([PROMPT], np.int64), (b, 1))
    gen_lf = dataclasses.replace(gen, max_length=len(PROMPT) + args.max_new)

    def run_lf(f_in, s_in):
        return longform_generate(model, gen_lf, f_in, s_in, attn, prompts_np)

    stno_tdev = torch.from_numpy(stno_np).to(dev)
    for label, f_in, s_in in (("host feats", feats_np, stno_np),
                              ("device feats", feats.float(), stno_tdev)):
        out = run_lf(f_in, s_in)  # warm
        t0 = time.perf_counter()
        out = run_lf(f_in, s_in)
        t_lf = time.perf_counter() - t0
        audio_s = out.windows_decoded * 30.0
        print(f"longform greedy e2e [{label}]: {t_lf * 1e3:8.1f} ms  "
              f"({out.windows_decoded} windows, {audio_s / t_lf:.0f}x "
              f"realtime)" + device_part(lambda: run_lf(f_in, s_in), t_lf),
              flush=True)
        per_window_dev = (t_enc + t_greedy)
        est = per_window_dev * out.windows_decoded / b
        print(f"  device-stage estimate:    {est * 1e3:8.1f} ms  "
              f"(host+transfer overhead {(t_lf - est) * 1e3:.0f} ms)",
              flush=True)
    print("kernel launches: " + json.dumps(kernels.launch_counts))


if __name__ == "__main__":
    main()
