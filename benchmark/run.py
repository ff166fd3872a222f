"""The benchmark's entry point:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. It exits non-zero and prints no result
without a CUDA device (or with fewer than the cell asks for), loads and
warms up the cell, measures for ``--seconds`` (``--trace 1``: the cell's
traced batches under ``torch.profiler``), checks the outputs against the
float32 reference, and prints the result as the last line of its standard
output: one JSON object with ``correct``, ``attempted``, ``failed``,
``metrics``, ``device`` and, last, ``checks`` (each number compared with
its limit), which also go to standard error as its last lines.

    python3 benchmark/run.py --workload <cell> --calibrate <seed> ...

reads the program's and the float8 control's numbers on each seed in one
process, for setting a limit.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def cache_env(root: Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths;
    no library loads JAX by itself."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["USE_TF"] = "0"
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "4"


def log(msg: str) -> None:
    print(msg, flush=True)


def checks_ok(checks: dict) -> bool:
    """Each number at or under its limit; a limit not set fails."""
    return all(limit is not None and value <= limit
               and not math.isnan(value) for value, limit in checks.values())


def main(argv=None, root: Path = ROOT, bench: Path = None,
         require_cuda: bool = True, t_start: float = T_START) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--calibrate", type=int, nargs="*")
    args = p.parse_args(argv)
    cache_env(root)
    sys.path.insert(0, str(root))
    import torch

    from benchmark import harness

    spec = harness.Spec(root, bench)
    cell = spec.cell(args.workload)
    if require_cuda:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < cell["chips"]:
            print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
                  f"found {torch.cuda.device_count()}", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        log(f"card: {harness.card_line()}")
        log(f"torch {torch.__version__} cuda {torch.version.cuda} "
            f"python {sys.version.split()[0]}")
    else:
        device = torch.device("cpu")
    driver = spec.driver(cell["driver"])
    if args.calibrate is not None:
        driver.calibrate(spec, args.workload, args.calibrate, args.seconds,
                         device, log)
        return 0
    res = driver.run(spec, args.workload, args.seed, args.seconds,
                     bool(args.trace), device, t_start, log)
    if require_cuda:
        log(f"card after the run: {harness.card_line()}")
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules that no run may load are loaded: {bad}",
              file=sys.stderr)
        return 3
    if args.trace:
        metrics = harness.read_per_layer(spec, args.workload, res["ctx"])
    else:
        metrics = {}
        for m in spec.end_to_end(args.workload):
            if m["name"] in res:
                metrics[m["name"]] = {"value": float(res[m["name"]]),
                                      "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": res["memory_peak_bytes"]}
    line = {"correct": checks_ok(res["checks"]),
            "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": dev}
    if args.trace:
        tr = res["trace"]
        dev["busy_s"] = tr["busy_s"]
        dev["window_s"] = tr["window_s"]
        line["breakdown"] = res.get("breakdown") or breakdown(res)
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in res["checks"].items()}
    print(json.dumps(line), flush=True)
    for k, (v, lim) in res["checks"].items():
        print(f"check {k}: {v} limit {lim}", file=sys.stderr)
    return 0


def breakdown(res: dict) -> dict:
    """The device operations that took most time, and the idle time by the
    innermost span the host was in (a sweep over the gaps in time order)."""
    from benchmark.devicetime import idle_gaps

    tr = res["trace"]
    ops = sorted(tr["by_name"].items(), key=lambda kv: -kv[1])[:10]
    spans = sorted(res["ctx"]["rec"].spans, key=lambda s: s[1])
    idle, active, k = {}, [], 0
    for s, e in idle_gaps(tr["records"], tr["start_ns"], tr["end_ns"]):
        mid = (s + e) // 2
        while k < len(spans) and spans[k][1] <= mid:
            active.append(spans[k])
            k += 1
        active = [a for a in active if a[2] >= mid]
        name = (min(active, key=lambda a: a[2] - a[1])[0] if active
                else "outside spans")
        idle[name] = idle.get(name, 0.0) + (e - s) / 1e9
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, v] for n, v in ops],
            "idle_gaps": [[n, v] for n, v in gaps]}


if __name__ == "__main__":
    sys.exit(main())
