"""Whole runs of the tiny cells on the CPU, each in its own process: the
result line and its checks, the same work for the same seed, no JAX, and
``correct`` false under each fault a cell can have."""

import json
import subprocess
import sys

import pytest

from benchmark.tests.conftest import ROOT

TIMEOUT = 600


def dry_run(tmp_path, cell, fault=""):
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.tests.dry_run", str(tmp_path),
         cell] + ([fault] if fault else []), cwd=ROOT, capture_output=True,
        text=True, timeout=TIMEOUT)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()


@pytest.mark.parametrize("cell", ["tiny.greedy", "tiny.train",
                                  "tiny_se.train"])
def test_sound_run_is_correct_and_loads_no_jax(tmp_path, cell):
    lines = dry_run(tmp_path, cell)
    res = json.loads(lines[-1])
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert set(res) >= {"correct", "attempted", "failed", "metrics",
                        "device"}
    assert "setup_s" in res["metrics"]
    work = [ln for ln in lines if ln.startswith("work a")]
    assert len(work) == 1
    again = dry_run(tmp_path / "again", cell)
    assert [ln for ln in again if ln.startswith("work a")] == work


@pytest.mark.parametrize("cell,fault", [
    ("tiny.greedy", "stale_state"), ("tiny.greedy", "half_batch"),
    ("tiny.greedy", "altered_token"), ("tiny.train", "stale_state"),
    ("tiny.train", "half_batch"), ("tiny_se.train", "stale_state"),
    ("tiny_se.train", "half_batch")])
def test_fault_is_not_correct(tmp_path, cell, fault):
    res = json.loads(dry_run(tmp_path, cell, fault)[-1])
    assert not res["correct"], res["checks"]


def test_reference_imports_nothing_of_the_port():
    code = ("import sys\n"
            "for name in ('ts_asr_whisper_tpu_torch', 'ts_asr_whisper_tpu',"
            " 'jax'):\n"
            "    sys.modules[name] = None\n"
            "import benchmark.reference.dicow, benchmark.reference.train\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('ts_asr_whisper_tpu_torch', 'ts_asr_whisper_tpu', 'jax')"
            " and sys.modules[m] is not None]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_no_cuda_no_result(tmp_path):
    """Without a card the benchmark exits non-zero and prints no result."""
    code = ("import sys\n"
            "import torch\n"
            "torch.cuda.is_available = lambda: False\n"
            "sys.argv = ['run.py', '--workload', 'dicow_v3.greedy_longform']\n"
            "from benchmark import run\n"
            "sys.exit(run.main())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_checkout_without_the_port_fails(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, a run exits non-zero and prints no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "dicow_v3.greedy_longform", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "{" not in out.stdout
