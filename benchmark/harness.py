"""What the benchmark finds by name: the spec (``BENCHMARK.json``), a cell
(``workloads/<cell>.json``), its configuration (``configs/<name>.json``),
its traffic mix (``traffic/<name>.json``), its driver
(``drivers/<kind>.py``) and the readers of its per-layer metrics
(``metrics/<metric>.py``, each with ``read(ctx) -> float | None``). Adding a
cell, a configuration or a metric adds files and entries, and edits no
code."""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
# top-level module names that no run may load, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "ts_asr_whisper_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Spec:
    """``BENCHMARK.json`` under ``root`` and the files it names under
    ``bench`` (this folder unless given)."""

    def __init__(self, root: Path, bench: Optional[Path] = None):
        self.root = Path(root)
        self.bench = Path(bench) if bench else HERE
        self.data = load_json(self.root / "BENCHMARK.json")

    def cell(self, name: str) -> dict:
        entries = [w for w in self.data["workloads"] if w["name"] == name]
        if not entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        cell = load_json(self.bench / "workloads" / f"{name}.json")
        entry = entries[0]
        for key in ("config", "traffic"):
            if cell[key] != entry[key]:
                raise ValueError(f"{name}: {key} {cell[key]!r} in its file, "
                                 f"{entry[key]!r} in BENCHMARK.json")
        cell["chips"] = entry["chips"]
        return cell

    def config(self, name: str) -> dict:
        return load_json(self.bench / "configs" / f"{name}.json")

    def traffic(self, name: str) -> dict:
        return load_json(self.bench / "traffic" / f"{name}.json")

    def end_to_end(self, cell: str) -> List[dict]:
        return [m for m in self.data["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> List[dict]:
        return [m for m in self.data["per_layer"]
                if cell in m.get("workloads", [cell])]

    def driver(self, kind: str):
        return load_module(self.bench / "drivers" / f"{kind}.py",
                           f"benchmark_driver_{kind}")

    def reader(self, metric: str) -> Callable[[dict], Optional[float]]:
        mod = load_module(self.bench / "metrics" / f"{metric}.py",
                          "benchmark_metric_" + metric.replace(".", "_"))
        return mod.read


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def read_per_layer(spec: Spec, cell: str, ctx: dict) -> Dict[str, dict]:
    """Every per-layer metric of the cell that its reader finds something
    to read for; a reader that finds nothing returns None and the metric is
    left out."""
    out = {}
    for m in spec.per_layer(cell):
        value = spec.reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def card_line() -> str:
    """The card's name, clocks and power limit (nvidia-smi), or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.max.sm,"
             "power.limit,power.draw,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
