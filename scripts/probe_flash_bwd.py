#!/usr/bin/env python
"""Probe: where the time of the flash-attention backward kernel goes, on one
NVIDIA GPU (sm_90a).

    python3 scripts/probe_flash_bwd.py

Builds variants of ``kernels/csrc/flash_attn_bwd.cu`` with parts of the main
kernel's loop cut out or done another way (text substitutions on a copy of the source, under
``build/probe_flash_bwd/``) and times each at the fine-tune shape
(4, 20, 1500, 64) bf16 with CUDA events around back-to-back calls, beside
the backward of
``F.scaled_dot_product_attention`` in the same process. A cut variant
computes wrong gradients (its errors against the plain backward are
printed); only its time is read. The gap between the full
kernel and a variant is what the cut part costs where it is not hidden.
Prints ptxas's register and spill lines for each build, the card's name and
power limit, and one JSON line of median times.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from ts_asr_whisper_tpu_torch import kernels  # noqa: E402

SHAPE = (4, 20, 1500, 64)
OUT = ROOT / "build" / "probe_flash_bwd"
# variant -> (old, new) substitutions on the source
VARIANTS = {
    "full": [],
    # the dq tile added row by row (64 reduce-adds of 256 bytes from padded
    # staging) instead of by one TMA tensor reduce-add
    "row_reduces": [
        ("                   const __grid_constant__ CUtensorMap dqmap,\n",
         "                   const __grid_constant__ CUtensorMap dqmap,\n"
         "                   float* __restrict__ dq_rows,\n"),
        ("        km, vm, qm, gm, dqm, lp, dp,",
         "        km, vm, qm, gm, dqm, acc, lp, dp,"),
        ("constexpr int DQ_STAGE = BQT * HD * 4;",
         "constexpr int DQ_STAGE = BQT * (HD + 8) * 4;"),
        ("stage + kr * HD + col", "stage + kr * (HD + 8) + col"),
        ("stage + (kr + 8) * HD + col", "stage + (kr + 8) * (HD + 8) + col"),
        ("      if (tid == 0) bulk_wait_read<1>();",
         "      if (tid < BQT) bulk_wait_read<1>();"),
        ("""      if (tid == 0) {  // one reduce-add of the tile; rows >= T clipped
        tma_reduce_add_3d(&dqmap, base + buf, 0, q0, bh);
        bulk_commit();
      }""",
         """      if (tid < BQT) {
        if (q0 + tid < t)
          asm volatile(
              "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 "
              "[%0], [%1], %2;" :: "l"(dq_rows + (row_base + q0 + tid) * HD),
              "r"(base + buf + tid * (HD + 8) * 4), "r"(HD * 4) : "memory");
        bulk_commit();
      }"""),
        ("    if (tid == 0) bulk_wait<0>();", "    if (tid < BQT) bulk_wait<0>();")],
    "no_dq_reduce": [("tma_reduce_add_3d(&dqmap",
                      "if (0) tma_reduce_add_3d(&dqmap")],
    "no_dq": [("tma_reduce_add_3d(&dqmap", "if (0) tma_reduce_add_3d(&dqmap"),
              ("wgmma_m64n64_ss<1, 1>(dq,", "if (0) wgmma_m64n64_ss<1, 1>(dq,")],
    "no_exp": [("exp2_approx(fmaf(sa[4 * i + e], LOG2E, nl))",
                "fmaf(sa[4 * i + e], LOG2E, nl)"),
               ("exp2_approx(fmaf(sa[4 * i + 2 + e], LOG2E, nl))",
                "fmaf(sa[4 * i + 2 + e], LOG2E, nl)")],
}


def build(name: str, subs) -> ctypes.CDLL:
    src = (kernels.CSRC / "flash_attn_bwd.cu").read_text()
    for old, new in subs:
        if old not in src:
            raise SystemExit(f"variant {name}: {old!r} not in the source")
        src = src.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    cu = OUT / f"{name}.cu"
    cu.write_text(src)
    lib = OUT / f"lib{name}.so"
    cmd = [kernels.find_nvcc(), *kernels.NVCC_FLAGS, f"-I{kernels.CSRC}",
           "-o", str(lib), str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {name}:\n{proc.stderr}")
    for line in (proc.stdout + proc.stderr).splitlines():
        if "registers" in line or "spill" in line or "warning" in line:
            print(f"[{name}] {line.strip()}")
    dll = ctypes.CDLL(str(lib))
    fn = dll.flash_attn_bwd
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return dll


def median_ms(fn, reps: int = 10, calls: int = 10) -> float:
    """Median over ``reps`` of the CUDA-event time of ``calls`` back-to-back
    calls, per call: the host enqueues ahead of the card, so this is the
    card's time per call."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return sorted(times)[reps // 2]


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: this probe runs only on the GPU")
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    from ts_asr_whisper_tpu_torch.ops import attention as A

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v, g = (torch.randn(SHAPE, device=dev, generator=gen) * s
                  for s in (0.125, 1.0, 1.0, 1.0))
    q, k, v, g = (x.bfloat16() for x in (q, k, v, g))
    out, lse = A.flash_mha_fwd(q, k, v, with_lse=True)
    b, h, t, d = SHAPE
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    big_d = torch.empty(b * h, t, device=dev)
    acc = torch.empty(b * h, t, d, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [x.data_ptr() for x in (q, k, v, g, out, lse, dq, dk, dv, big_d,
                                   acc)]
    ref = A.flash_mha_bwd_reference(q, k, v, out, lse, g)
    times = {}
    for name, subs in VARIANTS.items():
        fn = build(name, subs).flash_attn_bwd

        def call():
            err = fn(*ptrs, b * h, t, d, 1, 0, stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")

        call()
        torch.cuda.synchronize()
        rels = [((x.float() - r.float()).norm() / r.float().norm()).item()
                for x, r in zip((dq, dk, dv), ref)]
        print(f"{name}: dq/dk/dv Frobenius rel vs the plain backward "
              f"{', '.join(f'{e:.2e}' for e in rels)}")
        times[name] = median_ms(call)
    qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))
    lib_out = torch.nn.functional.scaled_dot_product_attention(qr, kr, vr,
                                                               scale=1.0)
    times["sdpa_backward"] = median_ms(lambda: torch.autograd.grad(
        lib_out, (qr, kr, vr), g, retain_graph=True))
    flop = 10 * b * h * t * t * d
    for name, ms in times.items():
        print(f"{name}: {ms:.4f} ms ({flop / ms / 1e9:.1f} TFLOP/s at the "
              "full kernel's FLOP count)")
    print(json.dumps({"shape": SHAPE, "median_ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
