"""Guards of the PyTorch port's package rules:

- the port (and chip_smoke.py) import neither jax nor any module of the JAX
  package;
- chip_smoke.py refuses to run without a GPU or outside the repository;
- every copy of a JAX-package module or data file is pinned to its source:
  unchanged copies by their text and yaml/json by their bytes, once the
  package names and the documentation edits of ``DOC_EDITS`` are made the
  same, and the copies the port changes by their behaviour on the same
  inputs (the copies are listed in ROADMAP.md).
"""

import dataclasses
import inspect
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
from ts_asr_whisper_tpu_torch import config as tcfgmod
from ts_asr_whisper_tpu_torch import decode as tdecode
from ts_asr_whisper_tpu_torch.data import datasets as tds
from ts_asr_whisper_tpu_torch.data import features as tfeat
from ts_asr_whisper_tpu_torch.data.synthetic import write_corpus
from ts_asr_whisper_tpu_torch.decoding import longform as tlf
from ts_asr_whisper_tpu_torch.eval import metrics as tmetrics
from ts_asr_whisper_tpu_torch.models import config as tconfig

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "ts_asr_whisper_tpu_torch"
JAXPKG = REPO / "ts_asr_whisper_tpu"
# modules copied unchanged (their text equals the source's once the package
# names are made the same, and the spans of TRACE_EDITS are put in)
UNCHANGED_COPIES = (
    "data/audio.py", "data/manifests.py", "data/notsofar.py", "data/stno.py",
    "data/collators.py", "data/augmentations.py", "data/tokenizer.py",
    "decoding/generation_config.py", "decoding/token_timestamps.py",
    "eval/postprocess.py", "eval/seglst.py",
    "eval/wer.py", "eval/wer_utils.py", "eval/orc.py", "eval/viz.py",
    "training/dataloader.py", "txt_norm/__init__.py", "txt_norm/nsf.py",
    "txt_norm/whisper_en.py", "utils/deprecated.py", "utils/logging_def.py")
# the copies' comments and docstrings name the reference by name, not by
# the absolute path of a checkout of it, and say "caller"/"scoring" where
# their sources say "driver"
CHECKOUT_PATH = re.compile(r"/\w+/reference/")
DOC_EDITS = (("# session driver (reference", "# per-session scoring (reference"),
             ("silence-chunked driver", "silence-chunked caller"))
DATA_COPIES = tuple(
    str(p.relative_to(JAXPKG)) for p in sorted(
        list((JAXPKG / "configs").rglob("*.yaml"))
        + list((JAXPKG / "txt_norm").glob("*.json"))))


def _run(code, cwd=REPO):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


# ---------------------------------------------------------------- imports


def test_port_imports_with_jax_blocked():
    mods = sorted("ts_asr_whisper_tpu_torch." + ".".join(
        p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py")
    code = ("import sys, json\nsys.modules['jax'] = None\n"
            "sys.modules['ts_asr_whisper_tpu'] = None\n"
            + "".join(f"import {m}\n" for m in mods)
            + "print(json.dumps(sorted(m for m, mod in sys.modules.items() "
              "if mod is not None and m.startswith('ts_asr_whisper_tpu'))))")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = set(json.loads(proc.stdout.splitlines()[-1]))
    assert {"ts_asr_whisper_tpu_torch.decode",
            "ts_asr_whisper_tpu_torch.train",
            "ts_asr_whisper_tpu_torch.pretrain_encoder",
            "ts_asr_whisper_tpu_torch.training.lora",
            "ts_asr_whisper_tpu_torch.parallel.dist",
            "ts_asr_whisper_tpu_torch.parallel.mesh",
            "ts_asr_whisper_tpu_torch.parallel.tensor"} <= loaded
    jax_pkg = {m for m in loaded if m == "ts_asr_whisper_tpu"
               or m.startswith("ts_asr_whisper_tpu.")}
    assert not jax_pkg


def test_port_sources_have_no_jax_import():
    pat = re.compile(r"^\s*(import jax|from jax)\b", re.M)
    files = list(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert PORT / "parallel" / "dist.py" in files
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert not offenders


def test_port_sources_do_not_import_the_jax_package():
    pat = re.compile(r"^\s*(from|import)\s+ts_asr_whisper_tpu(\.|\s|$)",
                     re.M)
    files = list(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert not offenders
    # the scan itself catches both forms, and leaves the port's own alone
    for line in ("from ts_asr_whisper_tpu.config import Cfg",
                 "import ts_asr_whisper_tpu.data.audio",
                 "    import ts_asr_whisper_tpu"):
        assert pat.search(line)
    assert not pat.search("from ts_asr_whisper_tpu_torch.config import Cfg")


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


@pytest.mark.parametrize("name", ["compression_ratio", "_needs_fallback"])
def test_fallback_checks_copy(name):
    """The fallback quality checks are longform.py:279-307 unchanged, and
    give the same verdicts."""
    assert inspect.getsource(getattr(tlf, name)) == \
        inspect.getsource(getattr(jlf, name))
    from ts_asr_whisper_tpu.decoding.generation_config import \
        GenerationConfig as JGen
    from ts_asr_whisper_tpu_torch.decoding.generation_config import \
        GenerationConfig as TGen

    seqs = ([5, 6, 7] * 12, list(range(40)), [], [51000, 3] * 5)
    for seq in seqs:
        if name == "compression_ratio" and seq:
            assert tlf.compression_ratio(seq, 51866) == \
                jlf.compression_ratio(seq, 51866)
        for kw in ({"compression_ratio_threshold": 2.4},
                   {"logprob_threshold": -1.0},
                   {"compression_ratio_threshold": 1.5,
                    "logprob_threshold": -0.2}):
            for lp in (-2.0, -0.5, 0.0):
                assert tlf._needs_fallback(seq, lp, TGen(**kw), 51866) == \
                    jlf._needs_fallback(seq, lp, JGen(**kw), 51866)


@pytest.mark.parametrize("name", ["set_joint_debug_decoder", "_debug_print"])
def test_joint_debug_printer_copy(name):
    """The debug printer and its decoder registration are
    ctc_rescorer.py:146-186 unchanged."""
    from ts_asr_whisper_tpu.decoding import ctc_rescorer as jctc
    from ts_asr_whisper_tpu_torch.decoding import ctc_rescorer as tctc

    assert inspect.getsource(getattr(tctc, name)) == \
        inspect.getsource(getattr(jctc, name))


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


# SE-DiCoW's enrollment selection (datasets.py:188-373) and the enrollment
# branches of cut_to_sample (:387-391, :497-501), copied unchanged
ENROLLMENT_COPIES = (
    "TS_ASR_DatasetSuperclass.sample_enrollment_window",
    "TS_ASR_DatasetSuperclass.downsample_mean",
    "TS_ASR_DatasetSuperclass.get_potentionally_parent_recording",
    "TS_ASR_DatasetSuperclass.select_random_internal_enrollment",
    "TS_ASR_DatasetSuperclass.mix_two_recordings",
    "TS_ASR_DatasetSuperclass.sample_offsets",
    "TS_ASR_DatasetSuperclass.sample_same_speaker_cut",
    "TS_ASR_DatasetSuperclass.generate_enrollment_mixture",
    "TS_ASR_DatasetSuperclass.get_conditioning_cut",
    "TS_ASR_DatasetSuperclass.cut_to_sample",
    "LhotseLongFormDataset.cut_to_sample",
)


@pytest.mark.parametrize("name", ENROLLMENT_COPIES)
def test_enrollment_selection_copy_is_unchanged(name):
    cls, meth = name.split(".")
    out = inspect.getsource(getattr(getattr(tds, cls), meth))
    assert out == inspect.getsource(getattr(getattr(jds, cls), meth))


@pytest.mark.parametrize("source", ["internal", "external"])
def test_dataset_copy_gives_the_same_enrollment_batches(corpus, tmp_path,
                                                        source):
    """Eval batches with SE-DiCoW enrollments: internal (the 30 s window of
    the recording where the target speaker talks most) and external (a
    mixture of the speaker's longest other recording and one other
    speaker's, from the enrollment cutset; the numpy RNG seeded alike)."""
    from ts_asr_whisper_tpu_torch.data.collators import \
        DataCollator as TDataCollator

    data = _data_cfg(use_enrollments=True, number_of_mixed_speakers=1)
    tok = ByteLevelTokenizer(vocab_size=2000)
    path, enroll = str(corpus), {}
    if source == "external":
        manifest = write_corpus(tmp_path / "enroll", (8.0, 9.0, 10.0), seed=5)
        path = path.replace(".jsonl.gz", "_external_enrollment.jsonl.gz")
        enroll = {mod: mod.load_cutsets([str(manifest)], False)[0]
                  for mod in (jds, tds)}
    batches = []
    for mod, collator_cls in ((jds, DataCollator), (tds, TDataCollator)):
        ds = mod.build_datasets([path], data, lambda x: x, 80,
                                enrollment_cutset=enroll.get(mod))
        collator = collator_cls(tokenizer=tok, bos_token_id=tok.bos_token_id,
                                max_length=40, use_enrollments=True)
        np.random.seed(11)
        (dataset,) = ds.values()
        batches.append(list(eval_batches(dataset, collator, 3,
                                         pad_to_full=True)))
    ref, out = batches
    assert len(out) == len(ref) == 2
    for (ri, r), (oi, o) in zip(ref, out):
        assert ri == oi and sorted(r) == sorted(o)
        assert r["enroll_features"].shape == (3, 80, 3000)
        assert r["enroll_stno"].shape == (3, 4, 1500)
        for k in r:
            np.testing.assert_array_equal(o[k], r[k], err_msg=k)
    # the enrollment is not the window itself
    assert not np.array_equal(ref[0][1]["enroll_features"],
                              ref[0][1]["input_features"][:, :, :3000])


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
    # each side reads a cut of its own manifest classes
    cut, ref_cut = (next(iter(ds.build_datasets(
        [str(corpus)], _data_cfg(), lambda x: x, 80)["eval_cutset"].cset))
        for ds in (tds, jds))
    preds, _ = _predictions(tok)
    for p in preds:
        assert list(tmetrics.process_session(p, tok, "spkA", cut)) == \
            list(jseglst.process_session(p, tok, "spkA", ref_cut))


def test_shortform_metrics_copy(tmp_path):
    """``compute_shortform_metrics`` (metrics.py:182-224), the pre-training
    dev scoring: the same source, and the same scores, texts and table on
    predictions with timestamps, -1 and -100 padding and an empty label."""
    assert inspect.getsource(tmetrics.compute_shortform_metrics) == \
        inspect.getsource(jmetrics.compute_shortform_metrics)
    tok = ByteLevelTokenizer(vocab_size=2000)
    norm = jtrain.get_text_norm("whisper_nsf")
    pad = [-100] * 4

    def ids(text, fill):
        return np.asarray(tok.encode_text(text) + fill)

    preds = [ids("<|0.00|> good morning to everyone<|2.00|>", [-1] * 3),
             ids("thanks for coming", []), ids("", [-1] * 5)]
    labels = [ids("good morning everyone", pad), ids("thanks for coming",
                                                     pad), ids("", pad)]
    (tmp_path / "j").mkdir()
    out = [mod.compute_shortform_metrics(
        preds, labels, tok, norm, output_dir=str(d), return_texts=True)
        for mod, d in ((tmetrics, tmp_path), (jmetrics, tmp_path / "j"))]
    assert out[0] == out[1]
    assert 0.0 < out[0][0]["wer"] < 1.0
    assert (tmp_path / "predictions.csv").read_text() == \
        (tmp_path / "j" / "predictions.csv").read_text()


@pytest.mark.parametrize("gen_json", [None, {"max_length": 200,
                                             "suppress_tokens": [1, 2],
                                             "no_speech_threshold": 0.6}])
def test_generation_config_copy(tmp_path, gen_json):
    model_dir = tmp_path / "m"
    model_dir.mkdir()
    if gen_json:
        (model_dir / "generation_config.json").write_text(json.dumps(gen_json))
    overrides = ["+decode=dicow_v3_greedy", f"model.whisper_model={model_dir}"]
    cfg = load_config(overrides, n_devices=1)
    tok = ByteLevelTokenizer(vocab_size=51866)
    mc = tconfig.make_config("large-v3-turbo")
    container = SimpleNamespace(tokenizer=tok, model_config=mc)
    # each side builds its own GenerationConfig class from its own config
    out = tdecode.make_generation_config(
        container, tcfgmod.load_config(overrides, n_devices=1))
    ref = jtrain.make_generation_config(container, cfg)
    assert dataclasses.asdict(out) == dataclasses.asdict(ref)


# ------------------------------------------------ copies of whole modules


def _doc_edited(text: str) -> str:
    text = CHECKOUT_PATH.sub("the reference's ", text)
    for old, new in DOC_EDITS:
        text = text.replace(old, new)
    return text


# the port's spans (utils/observability.py) in an unchanged copy: each
# (source text, copy's text) pair, found once in the source, is the copy's
# only change from it
TRACE_EDITS = {"training/dataloader.py": (
    ("the standard TPU host-overlap pattern.\n",
     "the standard TPU host-overlap pattern.\n\n"
     "Traced (utils/observability.py): each worker's batch is a "
     "``loader.batch``\nspan, the consumer's wait for one a ``loader.wait`` "
     "span, and each batch of\n``eval_batches`` a ``data.eval_batch`` "
     "span.\n"),
    ("import numpy as np\n",
     "import numpy as np\n\nfrom ..utils.observability import span\n"),
    ("            samples = [self.dataset[i] for i in batch_idx]\n"
     "            return self.collate_fn(samples)\n",
     "            with span(\"loader.batch\"):\n"
     "                samples = [self.dataset[i] for i in batch_idx]\n"
     "                return self.collate_fn(samples)\n"),
    ("                item = q.get()\n",
     "                with span(\"loader.wait\"):\n"
     "                    item = q.get()\n"),
    ("        samples = [dataset[j] for j in idx]\n"
     "        yield bi, collate_fn(samples)\n",
     "        with span(\"data.eval_batch\"):\n"
     "            samples = [dataset[j] for j in idx]\n"
     "            batch = collate_fn(samples)\n"
     "        yield bi, batch\n"),
)}


@pytest.mark.parametrize("rel", UNCHANGED_COPIES)
def test_unchanged_copy_equals_its_source(rel):
    src = _doc_edited((JAXPKG / rel).read_text())
    for old, new in TRACE_EDITS.get(rel, ()):
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    out = (PORT / rel).read_text().replace("ts_asr_whisper_tpu_torch",
                                           "ts_asr_whisper_tpu")
    assert out == src


@pytest.mark.parametrize("rel", DATA_COPIES)
def test_data_copy_is_byte_identical(rel):
    src = _doc_edited((JAXPKG / rel).read_text()).encode()
    assert (PORT / rel).read_bytes() == src


def test_copies_name_no_checkout_path():
    files = [p for p in PORT.rglob("*") if p.suffix in (".py", ".yaml",
                                                         ".json")]
    assert not [str(p) for p in files
                if CHECKOUT_PATH.search(p.read_text())]


def test_every_config_file_is_copied():
    assert len(DATA_COPIES) == 28  # 26 yaml + 2 json
    port_files = {str(p.relative_to(PORT)) for p in PORT.rglob("*")
                  if p.suffix in (".yaml", ".json")}
    assert port_files == set(DATA_COPIES)


CONFIG_CASES = [
    ["+decode=dicow_v3_greedy"],
    ["+decode=dicow_v3_beam_joint", "training.per_device_eval_batch_size=4",
     "model.ctc_weight=0.3"],
    ["+train=dicow_v3", "model.reinit_encoder_from=null",
     "data.train_cutsets=[/data/a_30s.jsonl.gz,/data/b.jsonl.gz]",
     "training.overall_batch_size=8", "training.gradient_accumulation_steps=2",
     "training.max_steps=8", "aug.musan_root=null",
     "training.learning_rate=1e-5"],
    ["+train=dicow_v3"],
    ["model.whisper_model=openai/whisper-large-v3-turbo",
     "training.mesh_shape=[1]", "decoding.length_penalty=0.1"],
]


@pytest.mark.parametrize("case", range(len(CONFIG_CASES)))
def test_config_copy_composes_equal_configs(case, monkeypatch):
    # the env-var paths of the recipes, set to fixed values
    for var in ("MANIFEST_DIR", "PRETRAINED_CTC_MODELS_PATH", "MUSAN_ROOT",
                "EXPERIMENT_PATH"):
        monkeypatch.setenv(var, f"/env/{var.lower()}")
    overrides = CONFIG_CASES[case]
    ref = load_config(overrides, n_devices=1)
    out = tcfgmod.load_config(overrides, n_devices=1)
    assert dataclasses.asdict(out) == dataclasses.asdict(ref)
    assert [f.name for f in dataclasses.fields(tcfgmod.Cfg)] == \
        [f.name for f in dataclasses.fields(type(ref))]
    # without a device count the port's copy asks nothing of jax: one device
    assert dataclasses.asdict(tcfgmod.load_config(overrides)) == \
        dataclasses.asdict(out)


def test_native_scoring_copy_gives_the_same_distances(rng):
    from ts_asr_whisper_tpu.eval import native as jn
    from ts_asr_whisper_tpu_torch.eval import native as tn

    assert tn._load() is not None, tn.build_log
    streams = []
    for _ in range(5):
        n = int(rng.integers(0, 30))
        begin = np.sort(rng.uniform(0, 20, n))
        streams.append((rng.integers(0, 8, n).astype(np.int32), begin,
                        begin + rng.uniform(0.1, 1.0, n)))
    for r in streams:
        for h in streams:
            assert tn.levenshtein(r[0], h[0]) == jn.levenshtein(r[0], h[0])
            assert tn.time_constrained_levenshtein(*r, *h, 0.5) == \
                jn.time_constrained_levenshtein(*r, *h, 0.5)
    np.testing.assert_array_equal(
        tn.pairwise_tclev_matrix(streams[:3], streams[2:], 1.0),
        jn.pairwise_tclev_matrix(streams[:3], streams[2:], 1.0))
    # the numpy fallback is the same code in both
    assert tn._py_tclev(*streams[0], *streams[1], 0.5) == \
        jn._py_tclev(*streams[0], *streams[1], 0.5)


def test_native_library_builds_into_the_hashed_directory():
    from ts_asr_whisper_tpu_torch.eval import native as tn

    lib = tn.build_library()
    assert lib is not None and lib.exists()
    assert lib.parent.parent == REPO / "build" / "native"


@pytest.mark.parametrize("channels,bps", [(1, 16), (2, 24)])
def test_flac_copy_decodes_the_same_samples(channels, bps):
    from flac_writer import encode_flac

    from ts_asr_whisper_tpu.data.flac import decode_flac_bytes as jdec
    from ts_asr_whisper_tpu_torch.data.flac import decode_flac_bytes as tdec

    rng = np.random.default_rng(channels)
    lim = 1 << (bps - 2)
    pcm = np.clip(np.cumsum(rng.integers(-200, 201, (channels, 5000)),
                            axis=1), -lim, lim - 1).astype(np.int64)
    data = encode_flac(pcm, 16000, bps=bps)
    out, ref = tdec(data), jdec(data)
    np.testing.assert_array_equal(out[0], ref[0])
    assert out[1:] == ref[1:] == (16000, bps)
    np.testing.assert_array_equal(out[0].astype(np.int64), pcm)


@pytest.mark.parametrize("n", [0, 1, 7, 10])
@pytest.mark.parametrize("rank, world", [(0, 1), (0, 2), (1, 2), (2, 3)])
def test_shard_indices_copy(monkeypatch, n, rank, world):
    """parallel/dist.py::shard_indices_by_process, the round-robin shard of
    JAX parallel/dist.py:104-109 with the rank and world size of the
    process group in place of jax's process index and count."""
    import jax

    from ts_asr_whisper_tpu.parallel import dist as jdist
    from ts_asr_whisper_tpu_torch.parallel import dist as tdist

    assert inspect.getdoc(tdist.shard_indices_by_process) == \
        inspect.getdoc(jdist.shard_indices_by_process)
    monkeypatch.setattr(jax, "process_index", lambda: rank)
    monkeypatch.setattr(jax, "process_count", lambda: world)
    monkeypatch.setattr(tdist, "get_rank", lambda: rank)
    monkeypatch.setattr(tdist, "world_size", lambda: world)
    assert tdist.shard_indices_by_process(n) == \
        jdist.shard_indices_by_process(n)


def test_metrics_logger_copy_is_unchanged(tmp_path):
    from ts_asr_whisper_tpu.utils import observability as jobs
    from ts_asr_whisper_tpu_torch.utils import observability as tobs

    assert inspect.getsource(tobs.MetricsLogger) == \
        inspect.getsource(jobs.MetricsLogger)
    logger = tobs.MetricsLogger(str(tmp_path))
    logger.log({"loss": np.float32(1.5)}, 3)
    logger.close()
    rec = json.loads((tmp_path / "metrics.jsonl").read_text())
    assert (rec["step"], rec["loss"]) == (3, 1.5)


def test_grad_param_norms_counterpart():
    import optax

    from ts_asr_whisper_tpu.utils.observability import grad_param_norms as jg
    from ts_asr_whisper_tpu_torch.utils.observability import \
        grad_param_norms as tg

    rng = np.random.default_rng(4)
    model = torch.nn.ModuleDict({"enc": torch.nn.Linear(3, 4),
                                 "dec": torch.nn.Linear(4, 2)})
    for p in model.parameters():
        p.grad = torch.from_numpy(rng.standard_normal(p.shape)
                                  .astype(np.float32))
    tree = {top: {name: p.detach().numpy() for name, p in m.named_parameters()}
            for top, m in model.items()}
    gtree = {top: {name: p.grad.numpy() for name, p in m.named_parameters()}
             for top, m in model.items()}
    ref = jg(gtree, tree)
    out = tg(model.named_parameters())
    for key in ("grad_norm/global", "param_norm/global"):
        np.testing.assert_allclose(out[key], ref[key], rtol=1e-6)
    np.testing.assert_allclose(out["grad_norm/enc.weight"],
                               float(optax.global_norm(gtree["enc"]["weight"])),
                               rtol=1e-6)


def test_training_dataset_copy_gives_the_same_items(corpus):
    data = _data_cfg()
    kw = dict(text_norm=lambda x: x, use_timestamps=True, num_mel_bins=80,
              global_lang_id="en")
    ref = jds.TS_ASR_Dataset(jds.load_cutsets([str(corpus)], False), **kw)
    out = tds.TS_ASR_Dataset(tds.load_cutsets([str(corpus)], False), **kw)
    assert len(out) == len(ref) == 4
    for i in range(len(ref)):
        r, o = ref[i], out[i]
        assert sorted(o) == sorted(r)
        for k in r:
            if isinstance(r[k], np.ndarray):
                np.testing.assert_array_equal(o[k], r[k], err_msg=k)
            else:
                assert o[k] == r[k], k
    assert data.use_timestamps
