"""The port's host tools (``ts_asr_whisper_tpu_torch/scripts``: score,
crosscheck_meeteval, bench_dataloader, compute_der_between_cutsets,
prepare_diar_cutset_from_rttm_dir, diarize) against their JAX scripts under
``scripts/`` on the same inputs, made from a seed: the same printed JSON and
the same files. Also the table of counterparts: every JAX script that
imports jax or the JAX package has its tool in the port."""

import gzip
import importlib.util
import json
import random
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch_parity_utils  # noqa: F401  (caps torch's threads)
from ts_asr_whisper_tpu_torch.data.manifests import CutSet, load_manifest
from ts_asr_whisper_tpu_torch.data.synthetic import write_corpus
from ts_asr_whisper_tpu_torch.eval.metrics import save_session_outputs
from ts_asr_whisper_tpu_torch.scripts import bench_dataloader as pbench
from ts_asr_whisper_tpu_torch.scripts import crosscheck_meeteval as pcross

REPO = Path(__file__).resolve().parents[1]
JAX_SCRIPTS = REPO / "scripts"
PORT_SCRIPTS = REPO / "ts_asr_whisper_tpu_torch" / "scripts"
# JAX script -> the port's tool (two drop "tpu" from their names)
COUNTERPARTS = {
    "profile_decode.py": "profile_decode.py",
    "tpu_kernel_check.py": "cuda_kernel_check.py",
    "probe_train_batch.py": "probe_train_batch.py",
    "probe_psi_gather.py": "probe_psi_gather.py",
    "export_dicow.py": "export_dicow.py",
    "smoke_decode.py": "smoke_decode.py",
    "submit_tpu.sh": "submit_gpu.sh",
    "score.py": "score.py",
    "crosscheck_meeteval.py": "crosscheck_meeteval.py",
    "bench_dataloader.py": "bench_dataloader.py",
    "compute_der_between_cutsets.py": "compute_der_between_cutsets.py",
    "prepare_diar_cutset_from_rttm_dir.py":
        "prepare_diar_cutset_from_rttm_dir.py",
    "diarize.py": "diarize.py",
}
JAX_IMPORT = re.compile(
    r"^\s*(import jax|from jax|(from|import)\s+ts_asr_whisper_tpu(\.|\s|$))",
    re.M)


def _jax(script, *args):
    out = subprocess.run([sys.executable, str(JAX_SCRIPTS / script),
                          *map(str, args)], capture_output=True, text=True,
                         timeout=300, cwd=REPO)
    assert out.returncode == 0, f"{script}:\n{out.stderr[-2000:]}"
    return out.stdout


def _port(tool, *args):
    out = subprocess.run([sys.executable, "-m",
                          f"ts_asr_whisper_tpu_torch.scripts.{tool}",
                          *map(str, args)], capture_output=True, text=True,
                         timeout=300, cwd=REPO)
    assert out.returncode == 0, f"{tool}:\n{out.stderr[-2000:]}"
    return out.stdout


def _lines(path: Path) -> list:
    with gzip.open(path, "rt") as f:
        return [json.loads(line) for line in f]


def test_every_jax_tool_has_a_port_counterpart():
    jax_tools = {p.name for p in JAX_SCRIPTS.glob("*.py")
                 if JAX_IMPORT.search(p.read_text())}
    assert jax_tools, "the scan found no JAX script"
    # the launcher runs main.py: it imports nothing, and is listed by name
    assert jax_tools | {"submit_tpu.sh"} == set(COUNTERPARTS)
    for jax_name, port_name in COUNTERPARTS.items():
        assert (JAX_SCRIPTS / jax_name).exists(), jax_name
        assert (PORT_SCRIPTS / port_name).exists(), port_name
        if port_name.endswith(".py"):
            src = (PORT_SCRIPTS / port_name).read_text()
            assert not JAX_IMPORT.search(src), port_name
            assert not re.search(r"^\s*import bench\b", src, re.M)
            assert 'if __name__ == "__main__":' in src, port_name


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("host_tools")
    return write_corpus(tmp / "corpus", durations=(9.0, 7.0), seed=3)


def test_score_writes_the_jax_scripts_csv(corpus, tmp_path):
    """A predictions dir as the port's eval writes it (hyp and ref SegLSTs
    per session), hypotheses drawn from the references' words."""
    rng = np.random.default_rng(0)
    refs = load_manifest(corpus)
    processed = {}
    for cut in refs:
        segs = []
        for sup in cut.supervisions:
            words = sup.text.split()
            keep = rng.random(len(words)) > 0.3
            segs.append({"session_id": cut.recording_id,
                         "speaker": sup.speaker,
                         "start_time": sup.start + rng.uniform(-0.5, 0.5),
                         "end_time": sup.end + rng.uniform(-0.5, 0.5),
                         "words": " ".join(np.asarray(words)[keep])})
        processed[cut.recording_id] = segs
    pred = tmp_path / "pred"
    save_session_outputs(processed, pred, lambda s: s, refs)
    copy = tmp_path / "copy"
    subprocess.run(["cp", "-r", str(pred), str(copy)], check=True)
    args = ("--metrics", "tcp_wer", "cp_wer", "--workers", "1")
    ref_out = json.loads(_jax("score.py", pred, *args))
    out = json.loads(_port("score", copy, *args))
    assert out == ref_out
    assert out["tcp_wer"] > 0
    assert (copy / "all_session_wer.csv").read_text() == \
        (pred / "all_session_wer.csv").read_text()


def _hyp_cutset(corpus: Path, out: Path, seed: int) -> Path:
    """The reference cutset with every supervision moved by up to 0.4 s and
    the speakers renamed, plus one false-alarm speaker."""
    rng = np.random.default_rng(seed)
    cuts = load_manifest(corpus)
    for cut in cuts:
        for sup in cut.supervisions:
            sup.start = round(max(0.0, sup.start + rng.uniform(-0.4, 0.4)), 2)
            sup.duration = round(sup.duration + rng.uniform(-0.4, 0.4), 2)
            sup.speaker = {"spkA": "hyp1", "spkB": "hyp0"}[sup.speaker]
        extra = type(cut.supervisions[0])(
            id=f"{cut.recording_id}-fa", recording_id=cut.recording_id,
            start=1.0, duration=0.5, speaker="hyp9", text="")
        cut.supervisions = list(cut.supervisions) + [extra]
    CutSet(list(cuts)).to_file(out)
    return out


def test_compute_der_matches_the_jax_script(corpus, tmp_path):
    hyp = _hyp_cutset(corpus, tmp_path / "hyp.jsonl.gz", seed=1)
    ref_out = json.loads(_jax("compute_der_between_cutsets.py", corpus, hyp,
                              "--align-output", tmp_path / "j.jsonl.gz"))
    out = json.loads(_port("compute_der_between_cutsets", corpus, hyp,
                           "--align-output", tmp_path / "p.jsonl.gz"))
    assert out == ref_out
    assert 0 < out["overall_der"] < 1
    aligned = _lines(tmp_path / "p.jsonl.gz")
    assert aligned == _lines(tmp_path / "j.jsonl.gz")
    speakers = {s["speaker"] for c in aligned for s in c["supervisions"]}
    assert speakers == {"spkA", "spkB", "-1"}


def test_prepare_diar_cutset_matches_the_jax_script(corpus, tmp_path):
    rng = np.random.default_rng(2)
    rttm_dir = tmp_path / "rttm"
    rttm_dir.mkdir()
    for cut in load_manifest(corpus):
        with open(rttm_dir / f"{cut.recording_id}.rttm", "w") as f:
            f.write("# a comment line\n")
            for i in range(4):
                start = rng.uniform(0, cut.duration - 1)
                f.write(f"SPEAKER {cut.recording_id} 1 {start:.3f} "
                        f"{rng.uniform(0.2, 1.0):.3f} <NA> <NA> S{i % 2} "
                        "<NA> <NA>\n")
    ref_out = _jax("prepare_diar_cutset_from_rttm_dir.py", rttm_dir, corpus,
                   tmp_path / "j.jsonl.gz")
    out = _port("prepare_diar_cutset_from_rttm_dir", rttm_dir, corpus,
                tmp_path / "p.jsonl.gz")
    assert out == ref_out.replace("j.jsonl", "p.jsonl")
    cuts = _lines(tmp_path / "p.jsonl.gz")
    assert cuts == _lines(tmp_path / "j.jsonl.gz")
    assert {s["speaker"] for c in cuts for s in c["supervisions"]} == {
        f"{c['recording']['id']}_S{i}" for c in cuts for i in (0, 1)}


def test_diarize_oracle_writes_the_jax_scripts_rttms(corpus, tmp_path):
    ref_out = _jax("diarize.py", corpus, tmp_path / "j", "--backend",
                   "oracle")
    out = _port("diarize", corpus, tmp_path / "p", "--backend", "oracle")
    assert out == ref_out.replace(str(tmp_path / "j"), str(tmp_path / "p"))
    names = sorted(p.name for p in (tmp_path / "j").glob("*.rttm"))
    assert names == sorted(p.name for p in (tmp_path / "p").glob("*.rttm"))
    assert len(names) == 2
    for name in names:
        text = (tmp_path / "p" / name).read_text()
        assert text == (tmp_path / "j" / name).read_text()
        assert text.startswith("SPEAKER rec")
    # an existing RTTM is kept as it is
    (tmp_path / "p" / names[0]).write_text("kept\n")
    _port("diarize", corpus, tmp_path / "p")
    assert (tmp_path / "p" / names[0]).read_text() == "kept\n"


@pytest.mark.parametrize(
    "pack", sorted((REPO / "tests" / "fixtures").glob("meeteval_pack*.json")),
    ids=lambda p: p.name)
def test_crosscheck_engines_hold_the_meeteval_pack(pack):
    data = json.loads(pack.read_text())
    collar = data["meta"]["collar"]
    assert data["sessions"]
    bad = []
    for i, sess in enumerate(data["sessions"]):
        bad.extend(pcross.check_session(sess["ref"], sess["hyp"], sess,
                                        collar, label=f"[{i}]"))
    assert not bad, "\n".join(bad)
    # the same sessions from the JAX script's checker
    spec = importlib.util.spec_from_file_location(
        "jax_crosscheck", JAX_SCRIPTS / "crosscheck_meeteval.py")
    jmod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jmod)
    rng_j, rng_p = np.random.default_rng(4), np.random.default_rng(4)
    for _ in range(5):
        assert pcross.random_session(rng_p) == jmod.random_session(rng_j)


def test_crosscheck_without_meeteval_exits_2(capsys):
    if importlib.util.find_spec("meeteval") is not None:
        pytest.skip("meeteval is installed: the tool would run")
    assert pcross.main(["--sessions", "2"]) == 2
    assert "meeteval is not installed" in capsys.readouterr().out


@pytest.mark.parametrize("device_mel", [False, True])
def test_bench_dataloader_matches_the_jax_script(tmp_path, device_mel):
    args = ["--n-cuts", "4", "--duration", "2", "--batch", "2",
            "--workers", "1"] + (["--device-mel"] if device_mel else [])
    ref = json.loads(_jax("bench_dataloader.py", *args).splitlines()[-1])
    out = json.loads(_port("bench_dataloader", "--device", "cpu",
                           *args).splitlines()[-1])
    assert sorted(out) == sorted(ref)
    assert out["device_mel"] is device_mel
    for key in ("metric", "unit", "workers", "worker_type", "host_cores"):
        assert out[key] == ref[key]
    assert out["value"] > 0


def test_bench_dataloader_collates_the_jax_scripts_batch(tmp_path):
    from ts_asr_whisper_tpu.data.collators import DataCollator
    from ts_asr_whisper_tpu.data.datasets import TS_ASR_Dataset, load_cutsets
    from ts_asr_whisper_tpu.data.tokenizer import ByteLevelTokenizer

    spec = importlib.util.spec_from_file_location(
        "jax_bench_dataloader", JAX_SCRIPTS / "bench_dataloader.py")
    jmod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jmod)
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    # the JAX script's dataset and collator, as its main builds them
    jman = jmod.make_corpus(tmp_path / "j", 4, 3.0)
    jds = TS_ASR_Dataset(load_cutsets([str(jman)], False),
                         text_norm=lambda x: x, use_timestamps=True,
                         num_mel_bins=80, global_lang_id="en")
    jcol = DataCollator(tokenizer=ByteLevelTokenizer(), bos_token_id=0,
                        max_length=64)
    pds, pcol = pbench.build_pipeline(pbench.make_corpus(tmp_path / "p", 4,
                                                         3.0))
    assert len(pds) == len(jds) == 4
    # the collator's augmentations draw from the global generators
    random.seed(0)
    np.random.seed(0)
    ref = jcol([jds[i] for i in (0, 1, 2)])
    random.seed(0)
    np.random.seed(0)
    out = pcol([pds[i] for i in (0, 1, 2)])
    assert sorted(out) == sorted(ref)
    for key, val in ref.items():
        np.testing.assert_array_equal(np.asarray(out[key]), np.asarray(val),
                                      err_msg=key)
