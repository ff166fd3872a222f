#!/usr/bin/env python
"""The two beam-step kernels of the PyTorch port on one NVIDIA GPU: phases 4
and 5 of ``chip_smoke.py`` alone, then each kernel's design choice swept at
the beam step's main shapes.

    python3 scripts/probe_beam_kernels.py

  1. the card, and the builds of ancestry_attn.cu and psi_gather_dot.cu with
     ptxas's registers and spills;
  2. chip_smoke phase 4 (ancestry attention: every pos class, a beam search's
     ancestry map, a CUDA-graph replay at three device positions) and phase
     5 (the psi gather + dot, fp32 and bf16, with its graph replay);
  3. ancestry at (Bb 10, H 20, T 448), bf16 and fp32, at cluster sizes 1,
     2, 4 and 8 (each a build of its own, with ANCESTRY_CLUSTER_BF16 /
     _F32 defined; the shipped build has 4 / 8): device time
     (torch.profiler) at pos 0, 1, 112, 224 and 447 on uniform ancestors,
     with a device pos of -1 (every CTA returns at once: the launch alone)
     and at pos 224 on a beam search's map, the median per call (CUDA
     events, wrapper included) at pos 224, and the host's time per call
     (500 launches enqueued back to back);
  4. psi at P (2, 51867, 375), ids (10, 512), fp32 and bf16, with 1, 2, 4
     and 8 rows per warp (PSI_ROWS_PER_WARP; the shipped build has 2):
     device time, per call and host time per call.
Each variant is first held against the plain version; the wrappers run
unchanged, on the variant's library. The last line is one JSON object with
every number.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from unittest import mock

sys.modules["jax"] = None  # the port never reaches jax
sys.modules["ts_asr_whisper_tpu"] = None
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from ts_asr_whisper_tpu_torch import kernels  # noqa: E402

CLUSTERS = (1, 2, 4, 8)
ROWS_PER_WARP = (1, 2, 4, 8)
ANC_POS = (0, 1, 112, 224, 447)


def cluster_defines(cl: int) -> tuple:
    return (f"-DANCESTRY_CLUSTER_BF16={cl}", f"-DANCESTRY_CLUSTER_F32={cl}")


def rows_defines(r: int) -> tuple:
    return (f"-DPSI_ROWS_PER_WARP={r}",)


def host_us(fn, calls: int = 500) -> float:
    """Host time per call: ``calls`` launches enqueued back to back (the
    card runs behind), on the host's clock, after a synchronise."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def sweep_ancestry(dev) -> dict:
    from ts_asr_whisper_tpu_torch.ops import beam_attention as BA

    gen = torch.Generator(device=dev).manual_seed(11)
    t, pos, _ = c.ANC_MAIN
    hist = c.beam_hist(11, t, dev)
    res = {}
    for dt in (torch.bfloat16, torch.float32):
        uniform = c.ancestry_inputs(dev, t, dt, gen)
        history = c.ancestry_inputs(dev, t, dt, gen, hist=hist)
        # the launch alone: a device pos of -1 makes every CTA return at once
        floor = torch.full((1,), -1, dtype=torch.int32, device=dev)
        for cl in CLUSTERS:
            lib = kernels.load("ancestry_attn", cluster_defines(cl))
            limit = lib.ancestry_attn_max_len(kernels.DTYPE_CODES[dt])
            if limit < t:
                c.log(f"[probe] ancestry {str(dt)[6:]} cluster {cl}: not "
                      f"measured, T {t} > {limit} does not fit the "
                      "shared-memory budget")
                continue
            with mock.patch.object(kernels, "ancestry_attn_lib", lambda: lib):
                for p in ANC_POS:
                    c.check_ancestry(uniform, p, f"cluster {cl} pos {p}")
                c.check_ancestry(history, pos, f"cluster {cl} beam history")

                def run(args, p):
                    return lambda: BA.ancestry_attention(*args, p, c.BEAMS)

                r = {f"device_ms_pos{p}": c.device_ms(run(uniform, p))
                     for p in ANC_POS}
                r["device_ms_launch_only"] = c.device_ms(run(uniform, floor))
                r["device_ms_beam_history"] = c.device_ms(run(history, pos))
                r["ms"] = c.median_ms(run(uniform, pos), reps=50)
                r["host_us"] = host_us(run(uniform, pos))
            res[f"{str(dt)[6:]}_cluster{cl}"] = r
            c.log(f"[probe] ancestry {str(dt)[6:]} cluster {cl}: device "
                  + ", ".join(f"pos {p} {c.fmt_ms(r[f'device_ms_pos{p}'])}"
                              for p in ANC_POS)
                  + f", launch only {c.fmt_ms(r['device_ms_launch_only'])}"
                  f"; beam history pos {pos} "
                  f"{c.fmt_ms(r['device_ms_beam_history'])}; per call at "
                  f"pos {pos} {r['ms']:.4f} ms, host {r['host_us']:.1f} us")
        b = c.ancestry_bound(uniform, pos)
        c.log(f"[probe] ancestry {str(dt)[6:]} bound at pos {pos}: "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
        res[f"{str(dt)[6:]}_bound_ms"] = b["bound_ms"]
    return res


def sweep_psi(dev) -> dict:
    from ts_asr_whisper_tpu_torch.ops import psi_gather as PG

    inp = c.psi_inputs(dev)
    audio_idx, ids, w = inp["audio_idx"], inp["ids"], inp["w"]
    res = {}
    for dt in (torch.float32, torch.bfloat16):
        p_vt = PG.padded_posterior(torch.exp(inp["logp_vt"]), dt)
        ref = PG.psi_gather_dot_reference(p_vt, audio_idx, ids, w)

        def run():
            return PG.psi_gather_dot(p_vt, audio_idx, ids, w)

        for r in ROWS_PER_WARP:
            lib = kernels.load("psi_gather_dot", rows_defines(r))
            with mock.patch.object(kernels, "psi_gather_dot_lib", lambda: lib):
                out = run()
                torch.cuda.synchronize()
                if not torch.allclose(out, ref, atol=0.0, rtol=c.PSI_TOL):
                    raise AssertionError(f"psi disagrees at {r} rows/warp")
                key = f"{str(dt)[6:]}_rows{r}"
                res[key] = {"device_ms": c.device_ms(run),
                            "ms": c.median_ms(run, reps=50),
                            "host_us": host_us(run),
                            **c.psi_bound(p_vt, ids, w)}
            c.log(f"[probe] psi {str(dt)[6:]} {r} rows per warp: device "
                  f"{c.fmt_ms(res[key]['device_ms'])} (bound "
                  f"{res[key]['bound_ms']:.4f} ms), per call "
                  f"{res[key]['ms']:.4f} ms, host "
                  f"{res[key]['host_us']:.1f} us")
        del p_vt
    return res


def main() -> int:
    kind = c.phase_card()
    dev = torch.device("cuda", 0)
    builds = [("ancestry_attn", ()), ("psi_gather_dot", ())]
    builds += [("ancestry_attn", cluster_defines(cl)) for cl in CLUSTERS]
    builds += [("psi_gather_dot", rows_defines(r)) for r in ROWS_PER_WARP]
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=len(builds)) as pool:
        list(pool.map(lambda b: kernels.build(*b), builds))
    for name, defines in builds:
        key = " ".join((name, *defines))
        for line in kernels.build_info[key]["log"].splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                c.log(f"[build] {key}: {line.strip()}")
    anc = c.phase_ancestry(dev)
    psi = c.phase_psi(dev)
    record = {"device": kind, "phase4": anc, "phase5": psi,
              "ancestry": sweep_ancestry(dev), "psi": sweep_psi(dev)}
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
