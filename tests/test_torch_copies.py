"""Guards of the PyTorch port's package rules:

- the port (and chip_smoke.py) import no jax, not even through a module of
  the JAX package;
- chip_smoke.py refuses to run without a GPU or outside the repository;
- every jax-free copy of a JAX-package host function gives what its source
  gives on the same input (the copies are listed in ROADMAP.md as debt).
"""

import dataclasses
import json
import re
import shutil
import subprocess
import sys
from decimal import Decimal
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torch_parity_utils  # noqa: F401  (caps torch's threads)
from ts_asr_whisper_tpu import train as jtrain
from ts_asr_whisper_tpu.config import load_config
from ts_asr_whisper_tpu.data import datasets as jds
from ts_asr_whisper_tpu.data.collators import DataCollator
from ts_asr_whisper_tpu.data.tokenizer import ByteLevelTokenizer
from ts_asr_whisper_tpu.decoding import longform as jlf
from ts_asr_whisper_tpu.eval import metrics as jmetrics
from ts_asr_whisper_tpu.eval import seglst as jseglst
from ts_asr_whisper_tpu.models import config as jconfig
from ts_asr_whisper_tpu.ops import mel as jmel
from ts_asr_whisper_tpu.training.dataloader import eval_batches
from ts_asr_whisper_tpu_torch import decode as tdecode
from ts_asr_whisper_tpu_torch.data import datasets as tds
from ts_asr_whisper_tpu_torch.data import features as tfeat
from ts_asr_whisper_tpu_torch.data.synthetic import write_corpus
from ts_asr_whisper_tpu_torch.decoding import longform as tlf
from ts_asr_whisper_tpu_torch.eval import metrics as tmetrics
from ts_asr_whisper_tpu_torch.models import config as tconfig

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "ts_asr_whisper_tpu_torch"
# JAX-package modules that import jax at the top, directly or through
# another module: the port must load none of them
JAX_REACHING = ("ts_asr_whisper_tpu.ops.mel", "ts_asr_whisper_tpu.data.datasets",
                "ts_asr_whisper_tpu.eval.metrics",
                "ts_asr_whisper_tpu.models.config",
                "ts_asr_whisper_tpu.decoding.longform",
                "ts_asr_whisper_tpu.train", "ts_asr_whisper_tpu.ops.attention")


def _run(code, cwd=REPO):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


# ---------------------------------------------------------------- imports


def test_port_imports_with_jax_blocked():
    mods = sorted("ts_asr_whisper_tpu_torch." + ".".join(
        p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py")
    code = ("import sys, json\nsys.modules['jax'] = None\n"
            + "".join(f"import {m}\n" for m in mods)
            + "print(json.dumps(sorted(m for m in sys.modules "
              "if m.startswith('ts_asr_whisper_tpu'))))")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = set(json.loads(proc.stdout.splitlines()[-1]))
    assert "ts_asr_whisper_tpu_torch.decode" in loaded
    assert not loaded & set(JAX_REACHING)


def test_port_sources_have_no_jax_import():
    pat = re.compile(r"^\s*(import jax|from jax)\b", re.M)
    files = list(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert not offenders


def test_chip_smoke_fails_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    # alone, without the rest of the repository
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120,
                          env={"PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


# ---------------------------------------------------------------- copies


@pytest.mark.parametrize("n_samples,n_mels", [(20000, 80), (500000, 128)])
def test_features_copy_is_bit_identical(rng, n_samples, n_mels):
    wav = (rng.standard_normal(n_samples) * 0.1).astype(np.float32)
    f_ref, m_ref = jmel.extract_features(wav, n_mels)
    f_out, m_out = tfeat.extract_features(wav, n_mels)
    np.testing.assert_array_equal(f_out, f_ref)
    np.testing.assert_array_equal(m_out, m_ref)
    np.testing.assert_array_equal(tfeat.mel_filter_bank(num_mel_filters=n_mels),
                                  jmel.mel_filter_bank(num_mel_filters=n_mels))


TS = 1000
RETRIEVE_CASES = [
    [TS + 0, 5, 6, TS + 100, TS + 100, 8, 9, TS + 200, TS + 250],
    [TS + 0, 5, 6, TS + 100, TS + 100, 8, 9, TS + 200],
    [TS + 0, 5, 6, 9, TS + 400],
    [TS + 10, 5, 6],
    [TS + 300, 5],
    [5, 6, 9],
    [TS + 3, TS + 3],
]


@pytest.mark.parametrize("case", range(len(RETRIEVE_CASES)))
def test_retrieve_segment_copy(case):
    seq = np.asarray(RETRIEVE_CASES[case])
    ref = jlf.retrieve_segment(seq, TS, 2400, 12.34, prompt_len=3)
    out = tlf.retrieve_segment(seq, TS, 2400, 12.34, prompt_len=3)
    assert out[1] == ref[1]
    assert [(s.start, s.end, s.tokens.tolist()) for s in out[0]] == \
        [(s.start, s.end, s.tokens.tolist()) for s in ref[0]]


def test_fix_timestamps_copy():
    def segs(mod, spec):
        return [[mod.Segment(start=a, end=b, tokens=np.asarray(t))
                 for a, b, t in row] for row in spec]

    spec = [
        [(0.0, 4.5, [TS, 5, 6, TS + 225]), (12.0, 31.2, [TS, 7, TS + 960]),
         (31.2, 61.24, [8, 9]), (75.0, 75.0, [TS])],
        [(29.99, 30.0, [10, 11]), (45.01, 60.0, [12])],
        [],
    ]
    ref = jlf.fix_timestamps_from_segmentation(segs(jlf, spec), TS, 7)
    out = tlf.fix_timestamps_from_segmentation(segs(tlf, spec), TS, 7)
    np.testing.assert_array_equal(out, ref)
    for x in (0.01, 0.03, 29.999, 1.2345):
        assert tlf.round_to_nearest_0_02(x) == jlf.round_to_nearest_0_02(x)
    assert isinstance(tlf.round_to_nearest_0_02(1.0), Decimal)


def test_model_config_copy():
    jf = [(f.name, f.default) for f in dataclasses.fields(jconfig.DiCoWConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tconfig.DiCoWConfig)]
    assert tf == jf
    assert tconfig.WHISPER_SIZES == jconfig.WHISPER_SIZES
    for size in tconfig.WHISPER_SIZES:
        t = tconfig.make_config(size, dtype="float32")
        j = jconfig.make_config(size, dtype="float32")
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.head_dim, t.timestamp_begin, t.num_fddts) == \
            (j.head_dim, j.timestamp_begin, j.num_fddts)
    assert tconfig.make_config("tiny").compute_dtype == torch.bfloat16
    assert tconfig.make_config("tiny").storage_dtype == torch.float32


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("copies")
    return write_corpus(tmp, durations=(12.0, 33.0), seed=3)


def _data_cfg(**kw):
    cfg = load_config(["data.use_timestamps=true",
                       "data.eval_text_norm=whisper_nsf"], n_devices=1)
    return dataclasses.replace(cfg.data, **kw)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_dataset_copy_gives_the_same_eval_batches(corpus, n_mels):
    data = _data_cfg()
    tok = ByteLevelTokenizer(vocab_size=2000)
    collator = DataCollator(tokenizer=tok, bos_token_id=tok.bos_token_id,
                            max_length=40)
    ref = jds.build_datasets([str(corpus)], data, lambda x: x, n_mels)
    out = tds.build_datasets([str(corpus)], data, lambda x: x, n_mels)
    assert list(out) == list(ref) == ["eval_cutset"]
    rb = list(eval_batches(ref["eval_cutset"], collator, 3, pad_to_full=True))
    ob = list(eval_batches(out["eval_cutset"], collator, 3, pad_to_full=True))
    assert len(ob) == len(rb) == 2
    for (ri, r), (oi, o) in zip(rb, ob):
        assert ri == oi and sorted(r) == sorted(o)
        for k in r:
            np.testing.assert_array_equal(o[k], r[k], err_msg=k)


def _predictions(tok):
    """Timestamped token streams per (cut, speaker) as the decoder emits
    them, some beyond the cut's end."""
    texts = {
        ("rec0_cut", "spkA"): "<|0.50|> good morning to<|3.00|>"
                              "<|4.00|> everyone here<|8.00|>",
        ("rec0_cut", "spkB"): "<|4.60|> thanks for coming<|7.20|>",
        ("rec1_cut", "spkA"): "<|1.00|> we will start<|5.00|>"
                              "<|28.00|> the budget the budget the budget"
                              " the budget the budget<|30.00|>",
        ("rec1_cut", "spkB"): "<|0.00|> schedule<|29.00|>",
    }
    keys, preds = [], []
    for (cut, spk), text in texts.items():
        keys.append(f"{cut},{spk}")
        preds.append(np.asarray(tok.encode_text(text)))
    return preds, keys


def test_metrics_copy_gives_the_same_scores(corpus, tmp_path):
    data = _data_cfg()
    tok = ByteLevelTokenizer(vocab_size=2000)
    norm = jtrain.get_text_norm("whisper_nsf")
    ref_ds = jds.build_datasets([str(corpus)], data, norm, 80)["eval_cutset"]
    out_ds = tds.build_datasets([str(corpus)], data, norm, 80)["eval_cutset"]
    preds, keys = _predictions(tok)
    metrics = ["tcp_wer", "cp_wer"]
    ref = jmetrics.compute_longform_metrics(preds, keys, ref_ds, tok,
                                            str(tmp_path / "jax"), norm,
                                            metrics_list=metrics)
    out = tmetrics.compute_longform_metrics(preds, keys, out_ds, tok,
                                            str(tmp_path / "port"), norm,
                                            metrics_list=metrics)
    assert out == ref
    assert 0.0 < out["tcp_wer"] < 1.0
    for name in ("all_session_wer.csv", "eval_predictions.jsonl"):
        assert (tmp_path / "port" / name).read_text() == \
            (tmp_path / "jax" / name).read_text()
    for f in (tmp_path / "jax" / "wer").rglob("*.json"):
        rel = f.relative_to(tmp_path / "jax")
        assert (tmp_path / "port" / rel).read_text() == f.read_text()


def test_process_session_copy(corpus):
    tok = ByteLevelTokenizer(vocab_size=2000)
    cut = next(iter(tds.build_datasets([str(corpus)], _data_cfg(),
                                       lambda x: x, 80)["eval_cutset"].cset))
    preds, _ = _predictions(tok)
    for p in preds:
        assert list(tmetrics.process_session(p, tok, "spkA", cut)) == \
            list(jseglst.process_session(p, tok, "spkA", cut))


@pytest.mark.parametrize("gen_json", [None, {"max_length": 200,
                                             "suppress_tokens": [1, 2],
                                             "no_speech_threshold": 0.6}])
def test_generation_config_copy(tmp_path, gen_json):
    model_dir = tmp_path / "m"
    model_dir.mkdir()
    if gen_json:
        (model_dir / "generation_config.json").write_text(json.dumps(gen_json))
    cfg = load_config(["+decode=dicow_v3_greedy",
                       f"model.whisper_model={model_dir}"], n_devices=1)
    tok = ByteLevelTokenizer(vocab_size=51866)
    mc = tconfig.make_config("large-v3-turbo")
    container = SimpleNamespace(tokenizer=tok, model_config=mc)
    assert tdecode.make_generation_config(container, cfg) == \
        jtrain.make_generation_config(container, cfg)
