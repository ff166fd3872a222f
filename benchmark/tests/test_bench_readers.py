"""The per-layer metric readers on a recorded fake trace and fake spans,
and the harness finding a metric, a cell and a configuration added as
files."""

import json
import shutil

import pytest

from benchmark import harness
from benchmark.devicetime import idle_gaps, kernel_seconds, union_s
from benchmark.roofline import MFU_PEAK
from benchmark.spans import Recorder

MS = 1_000_000  # ns


def fake_ctx():
    rec = Recorder()
    rec.spans = [("host_data", 0, 40 * MS), ("seek_loop", 40 * MS, 240 * MS),
                 ("encoder", 50 * MS, 90 * MS),
                 ("decode_loop", 100 * MS, 220 * MS),
                 ("data_wait", 0, 10 * MS), ("optimizer", 20 * MS, 26 * MS)]
    records = [("attn_fwd_bf16_sm90", 55 * MS, 57 * MS),
               ("attn_fwd_bf16_sm90", 60 * MS, 62 * MS),
               ("gemm", 61 * MS, 70 * MS),
               ("attn_bwd_prep", 100 * MS, 101 * MS),
               ("attn_bwd_bf16_sm90", 101 * MS, 105 * MS),
               ("attn_bwd_dq_cast", 105 * MS, 106 * MS)]
    trace = {"records": records, "busy_s": union_s(records),
             "window_s": 0.25, "start_ns": 0, "end_ns": 250 * MS}
    work = {"row_windows": 4, "seek_iterations": 2, "decoder_steps": 60,
            "updates": 2}
    return {"rec": rec, "trace": trace, "work": work,
            "flash_fwd_bounds": [1e-3, 1e-3], "flash_bwd_bounds": [2e-3],
            "flops": 0.5 * MFU_PEAK * 0.25, "wall_s": 0.25}


SPEC = harness.Spec(harness.HERE.parent)
EXPECTED = {
    "host_data_ms.decode": 10.0,           # 40 ms / 4 row-windows
    "seek_self_ms.decode": 20.0,           # (200 - 40 - 120) / 2
    "encoder_ms.decode": 10.0,             # 40 / 4
    "greedy_step_ms": 2.0,                 # 120 / 60
    "flash_fwd_roofline.decode": 50.0,     # 2 ms of bound / 4 ms
    "device_idle.decode": 100 * (1 - 0.018 / 0.25),
    "decode_mfu": 50.0,
    "data_wait_ms.train": 5.0,
    "optim_ms.train": 3.0,
    "flash_bwd_roofline.train": 100 * 2 / 6,
    "device_idle.train": 100 * (1 - 0.018 / 0.25),
    "train_mfu": 50.0,
}


def test_device_sums():
    ctx = fake_ctx()
    assert ctx["trace"]["busy_s"] == pytest.approx(0.018)
    assert kernel_seconds(ctx["trace"]["records"], "attn_fwd") == \
        pytest.approx(0.004)
    gaps = idle_gaps(ctx["trace"]["records"], 0, 250 * MS)
    assert gaps[0] == (0, 55 * MS) and gaps[-1] == (106 * MS, 250 * MS)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader(name):
    assert name in [m["name"] for m in SPEC.data["per_layer"]]
    assert SPEC.reader(name)(fake_ctx()) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_without_trace_reads_nothing_or_spans(name):
    """A reader that finds nothing to read returns None; never 0 for a
    share of a roofline or a peak."""
    ctx = fake_ctx()
    ctx["trace"] = None
    ctx["rec"] = Recorder()
    assert SPEC.reader(name)(ctx) is None


def test_added_files_are_found(tiny, tmp_path):
    """A metric, a cell and a configuration added as files and entries are
    found by the harness with no code edited."""
    root, bench = tiny
    (bench / "metrics" / "rows_per_s.decode.py").write_text(
        "def read(ctx):\n    return ctx['work']['row_windows'] / "
        "ctx['wall_s']\n")
    cfg = json.loads((bench / "configs" / "tiny.json").read_text())
    (bench / "configs" / "tiny2.json").write_text(
        json.dumps(dict(cfg, name="tiny2")))
    shutil.copy(bench / "workloads" / "tiny.greedy.json",
                bench / "workloads" / "tiny2.greedy.json")
    w = json.loads((bench / "workloads" / "tiny2.greedy.json").read_text())
    w.update(name="tiny2.greedy", config="tiny2")
    (bench / "workloads" / "tiny2.greedy.json").write_text(json.dumps(w))
    data = json.loads((root / "BENCHMARK.json").read_text())
    data["configs"].append(dict(data["configs"][0], name="tiny2"))
    data["workloads"].append(dict(data["workloads"][0], name="tiny2.greedy",
                                  config="tiny2"))
    data["per_layer"].append({
        "name": "rows_per_s.decode", "unit": "1/s", "better": "higher",
        "source": "program_counter", "layer": "decode runner and seek loop",
        "moves": "decode_rtfx", "workloads": ["tiny2.greedy"]})
    (root / "BENCHMARK.json").write_text(json.dumps(data))
    spec = harness.Spec(root, bench)
    assert spec.cell("tiny2.greedy")["config"] == "tiny2"
    assert spec.config("tiny2")["name"] == "tiny2"
    assert [m["name"] for m in spec.per_layer("tiny2.greedy")] == \
        ["rows_per_s.decode"]
    out = harness.read_per_layer(spec, "tiny2.greedy", fake_ctx())
    assert out == {"rows_per_s.decode": {"value": 16.0, "unit": "1/s"}}
