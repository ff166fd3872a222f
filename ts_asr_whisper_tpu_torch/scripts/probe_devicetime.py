"""Probe: the device records a ``torch.profiler`` trace loses, against the
age of the process, on the card.

The port's own probe (it has no JAX counterpart): the evidence for
utils/devicetime.py's lead. At each age in --ages (seconds since the
probe started; the card idles in between), --launches flash forwards at
the encoder's shape (16, 20, 1500, 64) bf16 are traced twice: with no lead,
where a trace can keep fewer device records than it has launches, and
after the 256 absorbing launches that ``measure_device_ms`` puts first.
Each line gives the launches, the device records caught and the device ms
per call as caught, both ways. Needs a CUDA device: exits 2 without one.

    python -m ts_asr_whisper_tpu_torch.scripts.probe_devicetime \
        [--ages 20 90 200] [--launches 20]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from .. import kernels
from ..ops.attention import flash_mha_fwd
from ..utils.devicetime import kernel_trace

SHAPE = (16, 20, 1500, 64)
LEAD = 256


def caught(trace: dict, n: int) -> str:
    records = sum(row[0] for row in trace["kernels"].values())
    return (f"{records} of {trace['launches']} device records, "
            f"{trace['us'] / 1e3 / n:.4f} ms a call as caught")


def main(argv=None) -> int:
    t0 = time.perf_counter()
    ap = argparse.ArgumentParser()
    ap.add_argument("--ages", type=float, nargs="+", default=[20, 90, 200])
    ap.add_argument("--launches", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: this probe runs only on the GPU")
        return 2
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(SHAPE, device=dev, generator=gen).to(
        torch.bfloat16) * s for s in (0.125, 1.0, 1.0))

    def fn():
        return flash_mha_fwd(q, k, v)

    fn()
    torch.cuda.synchronize()
    print(f"device {torch.cuda.get_device_name(dev)}; flash forward "
          f"{SHAPE} bf16, {args.launches} launches a trace", flush=True)
    for age in args.ages:
        time.sleep(max(0.0, age - (time.perf_counter() - t0)))
        bare = kernel_trace(fn, args.launches)
        led = kernel_trace(fn, args.launches, LEAD)
        print(f"age {time.perf_counter() - t0:6.1f} s: no lead "
              f"{caught(bare, args.launches)}; after {LEAD} absorbing "
              f"launches {caught(led, args.launches)} "
              f"({led['lost_in_lead']} of the lead's records lost)",
              flush=True)
    print("kernel launches: " + json.dumps(kernels.launch_counts))
    return 0


if __name__ == "__main__":
    sys.exit(main())
