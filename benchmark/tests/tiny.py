"""A tiny copy of the benchmark for tests on the CPU: the same code, a
configuration of small widths with the port's tokenizer ids, short
recordings, a few tokens a window."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]

TINY = {
    "name": "tiny", "source": "test", "d_model": 128, "encoder_layers": 2,
    "decoder_layers": 2, "encoder_attention_heads": 2,
    "decoder_attention_heads": 2, "encoder_ffn_dim": 256,
    "decoder_ffn_dim": 256, "num_mel_bins": 80, "vocab_size": 2000,
    "max_source_positions": 1500, "max_target_positions": 448,
    "ctc_weight": 0.3, "additional_self_attention_layer": True,
    "pre_ctc_sub_sample": True, "fddt_is_diagonal": True,
    "use_pre_pos_fddt": True, "apply_fddt_to_n_layers": -1,
    "non_target_fddt_value": 0.5, "scb_layers": 0, "dtype": "bfloat16",
    "param_dtype": "float32", "bf16_full_eval": True,
}

TINY_MIX = {"name": "tiny_longform", "why": "test",
            "batch_template": [{"speakers": 2, "seconds": [31.0, 45.0]},
                               {"speakers": 2, "seconds": [10.0, 20.0]}],
            "turn_seconds": [2.0, 5.0], "overlap": [0.1, 0.2]}


def tiny_tokens(vocab: int) -> dict:
    from ts_asr_whisper_tpu_torch.data.tokenizer import ByteLevelTokenizer

    t = ByteLevelTokenizer(vocab_size=vocab)
    return {"eos": t.eos_token_id, "sot": t.sot_token_id,
            "en": t.lang_to_id["<|en|>"], "transcribe": t.transcribe_token_id,
            "no_timestamps": t.no_timestamps_token_id,
            "timestamp_begin": t.timestamp_begin}


def make_tiny(tmp: Path, new_tokens: int = 6) -> tuple:
    """(root, bench) of a benchmark with one tiny greedy cell."""
    real = json.loads((HERE / "configs" / "dicow_v3_turbo.json").read_text())
    bench = tmp / "bench"
    for sub in ("drivers", "metrics"):
        shutil.copytree(HERE / sub, bench / sub)
    for sub in ("configs", "workloads", "traffic"):
        (bench / sub).mkdir(parents=True, exist_ok=True)
    cfg = dict(TINY, port_overrides=real["port_overrides"],
               tokens=tiny_tokens(TINY["vocab_size"]))
    (bench / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "tiny_longform.json").write_text(
        json.dumps(TINY_MIX))
    cell = json.loads((HERE / "workloads" /
                       "dicow_v3.greedy_longform.json").read_text())
    cell.update(name="tiny.greedy", config="tiny", traffic="tiny_longform",
                batch_size=4, new_tokens=new_tokens, window_batches=2,
                trace_batches=1, check_row_windows=20)
    (bench / "workloads" / "tiny.greedy.json").write_text(json.dumps(cell))
    tcell = json.loads((HERE / "workloads" / "dicow_v3.train.json")
                       .read_text())
    tcell.update(name="tiny.train", config="tiny", traffic="tiny_train",
                 micro_batch=2, check_updates=2, check_rows=2,
                 trace_updates=1)
    (bench / "workloads" / "tiny.train.json").write_text(json.dumps(tcell))
    tmix = json.loads((HERE / "traffic" / "train_30s.json").read_text())
    tmix.update(name="tiny_train", cuts=4)
    (bench / "traffic" / "tiny_train.json").write_text(json.dumps(tmix))
    se = dict(cfg, name="tiny_se", scb_layers=1, use_enrollments=True,
              port_overrides=cfg["port_overrides"] + [
                  "model.scb_layers=1", "model.use_enrollments=true",
                  "data.use_enrollments=true"])
    (bench / "configs" / "tiny_se.json").write_text(json.dumps(se))
    scell = json.loads((HERE / "workloads" / "se_dicow.train.json")
                       .read_text())
    scell.update(name="tiny_se.train", config="tiny_se",
                 traffic="tiny_train_enroll", micro_batch=2, accumulation=2,
                 check_updates=2, check_rows=2, trace_updates=1,
                 limits=tcell["limits"])
    (bench / "workloads" / "tiny_se.train.json").write_text(
        json.dumps(scell))
    emix = json.loads((HERE / "traffic" / "train_30s_enroll.json")
                      .read_text())
    emix.update(name="tiny_train_enroll", cuts=4)
    (bench / "traffic" / "tiny_train_enroll.json").write_text(
        json.dumps(emix))
    spec = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    spec["configs"] = [{"name": "tiny", "source": "test",
                        "file": "bench/configs/tiny.json", "reduced": [],
                        "why": "test"}]
    spec["workloads"] = [{"name": "tiny.greedy", "config": "tiny",
                          "traffic": "tiny_longform", "chips": 1,
                          "why": "test"},
                         {"name": "tiny.train", "config": "tiny",
                          "traffic": "tiny_train", "chips": 1,
                          "why": "test"},
                         {"name": "tiny_se.train", "config": "tiny_se",
                          "traffic": "tiny_train_enroll", "chips": 1,
                          "why": "test"}]
    rename = {"dicow_v3.greedy_longform": "tiny.greedy",
              "dicow_v3.train": "tiny.train",
              "se_dicow.train": "tiny_se.train"}
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [rename[w] for w in m["workloads"]
                              if w in rename]
            if "tiny.train" in m["workloads"]:
                m["workloads"].append("tiny_se.train")
    root = tmp / "root"
    root.mkdir(parents=True, exist_ok=True)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root, bench
