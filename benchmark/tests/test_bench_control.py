"""On the card, at each cell's own size, on three seeds: the program's
numbers within their limits and the float8 control's outside one of them
(``python -m pytest benchmark/tests -m cuda``; a few minutes a cell)."""

import json
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests.conftest import ROOT

SPEC = harness.Spec(ROOT)
SEEDS = ["3000000041", "3000000042", "3000000043"]


def _calibrate(cell):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell,
         "--calibrate", *SEEDS, "--seconds", "1"], cwd=ROOT,
        capture_output=True, text=True, timeout=1800)
    assert out.returncode == 0, out.stderr[-3000:]
    return [json.loads(ln) for ln in out.stdout.splitlines()
            if ln.startswith('{"seed"')]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC.data["workloads"]])
def test_control_fails_where_the_program_passes(cuda, cell):
    limits = SPEC.cell(cell)["limits"]
    rows = _calibrate(cell)
    assert len(rows) == len(SEEDS)
    for row in rows:
        control = row["control"]
        prog = {k: row[k] for k in limits if k in row}
        assert all(v <= limits[k] for k, v in prog.items()), row
        assert any(v > limits[k] for k, v in control.items()
                   if k in limits), row
