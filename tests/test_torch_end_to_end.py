"""The port's CLI (``python -m ts_asr_whisper_tpu_torch --device cpu``)
against the JAX CLI (``main.main``) on the verify recipe's synthetic corpus
and the same safetensors weights: identical tcpWER hypothesis files and
equal tcp_wer, for long-form greedy decode and for beam-5 joint-CTC decode
(``+decode=dicow_v3_beam_joint``, with the CTC head in the weights), and
for SE-DiCoW's ``+decode=se_dicow_greedy`` and ``+decode=se_dicow_beam_joint``
on a corpus with external enrollments, and for beam joint CTC over the int8
cross-KV with the model's ``generation_config.json`` asking for
temperature-fallback retries; the same logged losses and a
loadable HF export for the fine-tune; and no run at all without a GPU unless
``--device cpu`` asks for the CPU."""

import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import torch_parity_utils  # noqa: F401  (caps torch's threads)
from ts_asr_whisper_tpu.config import load_config
from ts_asr_whisper_tpu.models.containers import WhisperContainer
from ts_asr_whisper_tpu.models.convert import params_to_hf, save_safetensors
from ts_asr_whisper_tpu_torch.data.synthetic import write_corpus

REPO = Path(__file__).resolve().parents[1]
MODEL = {"vocab_size": 2000, "num_mel_bins": 80, "d_model": 32,
         "encoder_layers": 2, "decoder_layers": 2,
         "encoder_attention_heads": 2, "decoder_attention_heads": 2,
         "encoder_ffn_dim": 64, "decoder_ffn_dim": 64,
         "max_source_positions": 1500, "max_target_positions": 64}


def _save_weights(corpus, overrides, tmp):
    """The weights the JAX CLI builds for this config into the model dir,
    sharpened so that the decode emits text tokens and timestamps instead
    of all deletions; SE-DiCoW's SCB gates opened (a fresh gate is 0)."""
    jcfg = load_config(overrides(corpus, tmp / "unused"), n_devices=1)
    jc = WhisperContainer(jcfg, seed=7)
    params = jax.tree.map(np.asarray, jc.params)
    emb = params["decoder"]["embed_tokens"] * 60
    ts_begin = jc.model_config.timestamp_begin
    emb[:32] = 0.0                                 # control bytes
    emb[127: jc.model_config.eos_token_id] = 0.0  # non-ASCII, unused ids
    emb[ts_begin + 100:] = 0.0                     # timestamps past 2 s
    params["decoder"]["embed_tokens"] = emb
    if "ca_enrolls" in params["encoder"]:
        params["encoder"]["ca_enrolls"]["gate"] = np.full_like(
            params["encoder"]["ca_enrolls"]["gate"], 0.8)
    save_safetensors(params_to_hf(params, jc.model_config),
                     str(corpus["model"] / "model.safetensors"))


def _make_corpus(tmp, overrides):
    manifest = write_corpus(tmp, durations=(10.0, 7.0), seed=0)
    model_dir = tmp / "model"
    model_dir.mkdir()
    (model_dir / "config.json").write_text(json.dumps(MODEL))
    corpus = {"eval": manifest, "model": model_dir, "tmp": tmp}
    _save_weights(corpus, overrides, tmp)
    return corpus


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return _make_corpus(tmp_path_factory.mktemp("torch_e2e"), _overrides)


@pytest.fixture(scope="module")
def corpus_ctc(tmp_path_factory):
    """The same corpus, with weights that carry the CTC head."""
    return _make_corpus(tmp_path_factory.mktemp("torch_e2e_ctc"),
                        _beam_joint_overrides)


def _overrides(corpus, out_dir):
    return [f"model.whisper_model={corpus['model']}",
            "data.train_cutsets=[]", "data.dev_cutsets=[]",
            f"data.eval_cutsets=[{corpus['eval']}]",
            "data.use_timestamps=true", "data.train_text_norm=null",
            "data.eval_text_norm=null", "model.ctc_weight=0.0",
            "model.dtype=float32", "training.decode_only=true",
            "training.per_device_eval_batch_size=4",
            "training.generation_max_length=40", "training.mesh_shape=[1]",
            f"training.output_dir={out_dir}"]


@pytest.fixture(scope="module")
def corpus_fallback(tmp_path_factory):
    """The CTC corpus, whose model dir also holds a generation_config.json
    with a temperature ladder of (0.0, 0.0) and quality thresholds that
    every window fails: each window's beam pass is retried greedily (by
    argmax at 0.0, so both CLIs give the same tokens)."""
    corpus = _make_corpus(tmp_path_factory.mktemp("torch_e2e_fallback"),
                          _beam_joint_overrides)
    (corpus["model"] / "generation_config.json").write_text(json.dumps(
        {"temperature": [0.0, 0.0], "logprob_threshold": 0.0,
         "compression_ratio_threshold": 2.4}))
    return corpus


def _fallback_int8_overrides(corpus, out_dir):
    return [*_beam_joint_overrides(corpus, out_dir),
            "decoding.cross_kv_quant=true"]


def _beam_joint_overrides(corpus, out_dir):
    """dicow_v3_beam_joint (beams 5, batch 2, decoding CTC weight 0.2,
    length penalty 0.1) on the tiny model, in fp32."""
    return ["+decode=dicow_v3_beam_joint",
            f"model.whisper_model={corpus['model']}",
            "data.train_cutsets=[]", "data.dev_cutsets=[]",
            f"data.eval_cutsets=[{corpus['eval']}]",
            "data.train_text_norm=null", "data.eval_text_norm=null",
            "model.ctc_weight=0.3", "model.dtype=float32",
            "training.generation_max_length=40", "training.mesh_shape=[1]",
            "training.save_visualizations=false",
            f"training.output_dir={out_dir}"]


def _se_dicow_overrides(decode, ctc_weight):
    """SE-DiCoW decode on the enrollment corpus: one SCB (the tiny model has
    two encoder layers), the eval cutset marked for external enrollment
    mixtures from the enrollment cutset, no other speaker mixed in (the
    mixture is then the speaker's longest enrollment cut, whatever the
    numpy RNG of either process)."""
    def overrides(corpus, out_dir):
        return [f"+decode={decode}", f"model.whisper_model={corpus['model']}",
                "data.train_cutsets=[]", "data.dev_cutsets=[]",
                f"data.eval_cutsets=[{corpus['eval']}]",
                f"data.enrollment_cutsets=[{corpus['enroll']}]",
                "data.number_of_mixed_speakers=0",
                "data.train_text_norm=null", "data.eval_text_norm=null",
                "model.scb_layers=1", f"model.ctc_weight={ctc_weight}",
                "model.dtype=float32", "training.generation_max_length=40",
                "training.per_device_eval_batch_size=2",
                "training.mesh_shape=[1]",
                "training.save_visualizations=false",
                f"training.output_dir={out_dir}"]
    return overrides


SE_DICOW = {"se_dicow_greedy": _se_dicow_overrides("se_dicow_greedy", 0.0),
            "se_dicow_beam_joint": _se_dicow_overrides("se_dicow_beam_joint",
                                                       0.3)}


@pytest.fixture(scope="module")
def enroll_corpus(tmp_path_factory):
    """The enrollment corpus of tests/test_end_to_end.py:194-231: two 8 s
    two-speaker recordings, and per-speaker enrollment recordings with other
    recording ids; model weights for each SE-DiCoW decode."""
    from test_end_to_end import _cut, _make_recording, _sup, _write_manifest

    tmp = tmp_path_factory.mktemp("torch_e2e_enroll")
    rng = np.random.default_rng(1)
    cuts = []
    for i in range(2):
        rec = _make_recording(tmp, f"tr{i}", 8.0, rng)
        cuts.append(_cut(rec, f"tr{i}_cut", [
            _sup(rec["id"], 0.5, 3.0, "hello world again", "spkA"),
            _sup(rec["id"], 4.0, 3.0, "yes indeed quite so", "spkB")]))
    _write_manifest(tmp / "tr_cutset_30s.jsonl.gz", cuts)
    enroll = []
    for spk in ("spkA", "spkB"):
        for j in range(2):
            rec = _make_recording(tmp, f"enr_{spk}_{j}", 5.0 + j, rng)
            enroll.append(_cut(rec, f"enr_{spk}_{j}_cut", [
                _sup(rec["id"], 0.2, 4.5, "enrollment speech", spk)]))
    _write_manifest(tmp / "enroll_cutset.jsonl.gz", enroll)
    corpora = {}
    for name, overrides in SE_DICOW.items():
        model_dir = tmp / f"model_{name}"
        model_dir.mkdir()
        (model_dir / "config.json").write_text(json.dumps(MODEL))
        corpora[name] = {
            "eval": tmp / "tr_cutset_30s_external_enrollment.jsonl.gz",
            "enroll": tmp / "enroll_cutset.jsonl.gz", "model": model_dir,
            "tmp": tmp}
        _save_weights(corpora[name], overrides, tmp)
    return corpora


def test_port_cli_matches_jax_cli(corpus, tmp_path):
    _check_cli(corpus, tmp_path, _overrides)


def test_port_beam_joint_cli_matches_jax_cli(corpus_ctc, tmp_path):
    _check_cli(corpus_ctc, tmp_path, _beam_joint_overrides)


def test_port_fallback_int8_cli_matches_jax_cli(corpus_fallback, tmp_path):
    _check_cli(corpus_fallback, tmp_path, _fallback_int8_overrides)


@pytest.mark.parametrize("decode", sorted(SE_DICOW))
def test_port_se_dicow_cli_matches_jax_cli(enroll_corpus, tmp_path, decode):
    _check_cli(enroll_corpus[decode], tmp_path, SE_DICOW[decode],
               name="tr_cutset_30s_external_enrollment")


def _check_cli(corpus, tmp_path, overrides, name="eval_cutset"):
    import main as jax_main

    jax_out, port_out = tmp_path / "jax", tmp_path / "port"
    ref = jax_main.main(overrides(corpus, jax_out))
    proc = subprocess.run(
        [sys.executable, "-m", "ts_asr_whisper_tpu_torch", "--device", "cpu",
         *overrides(corpus, port_out)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "2",
             "PYTHONPATH": str(REPO), "HOME": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "final metrics" in proc.stderr

    jax_hyps = sorted((jax_out / f"test_{name}").rglob("tcp_wer_hyp.json"))
    port_hyps = sorted((port_out / f"test_{name}").rglob("tcp_wer_hyp.json"))
    assert [p.relative_to(jax_out) for p in jax_hyps] == \
        [p.relative_to(port_out) for p in port_hyps]
    assert len(port_hyps) == 2
    words = 0
    for a, b in zip(jax_hyps, port_hyps):
        segs = json.loads(b.read_text())
        assert segs == json.loads(a.read_text())
        words += sum(len(s["words"].split()) for s in segs)
    assert words > 0  # the decode emitted text, not only deletions
    port_csv = port_out / f"test_{name}" / "step_0" / "all_session_wer.csv"
    assert port_csv.exists()
    key = f"eval_{name}_tcp_wer"
    line = [ln for ln in proc.stderr.splitlines() if "final metrics" in ln][0]
    assert f"'{key}': {ref[key]}" in line


def test_cli_refuses_to_run_without_a_gpu_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CLI would run on it")
    proc = subprocess.run(
        [sys.executable, "-m", "ts_asr_whisper_tpu_torch",
         "training.decode_only=true", f"training.output_dir={tmp_path}"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO),
             "HOME": str(tmp_path)})
    assert proc.returncode != 0
    assert "--device cpu" in proc.stderr
    assert not (tmp_path / "metrics.jsonl").exists()


def _train_overrides(corpus, out_dir):
    """The base config's fine-tune on the tiny model in fp32, augmentations
    off: one preheat epoch of 2 micro-batches, then 1 base step."""
    return [f"model.whisper_model={corpus['model']}",
            f"data.train_cutsets=[{corpus['train']}]",
            "data.dev_cutsets=[]", "data.eval_cutsets=[]",
            "model.dtype=float32", "aug.stno_gaussian_noise_var=null",
            "aug.stno_gaussian_noise_prob=0.0",
            "aug.stno_segment_augment_prob=0.0", "aug.spec_aug_prob=0.0",
            # an explicit micro-batch: the JAX CLI would divide
            # overall_batch_size by the test's 8 virtual devices
            "training.overall_batch_size=0",
            "training.per_device_train_batch_size=2", "training.max_steps=3",
            "training.warmup_steps=0", "training.eval_strategy=no",
            "training.save_strategy=no", "training.logging_steps=1",
            "training.dataloader_num_workers=1", "training.mesh_shape=[1]",
            f"training.output_dir={out_dir}"]


@pytest.fixture(scope="module")
def train_corpus(tmp_path_factory):
    """Two 30 s two-speaker recordings (4 training rows) and a tiny model
    whose weights both CLIs load."""
    tmp = tmp_path_factory.mktemp("torch_train")
    train = write_corpus(tmp / "corpus", durations=(30.0, 30.0), seed=0)
    model_dir = tmp / "model"
    model_dir.mkdir()
    (model_dir / "config.json").write_text(json.dumps(
        {**MODEL, "d_model": 128, "encoder_ffn_dim": 256,
         "decoder_ffn_dim": 256, "max_target_positions": 448}))
    corpus = {"model": model_dir, "train": train}
    jcfg = load_config(_train_overrides(corpus, tmp / "unused"), n_devices=1)
    jc = WhisperContainer(jcfg, seed=7)
    save_safetensors(params_to_hf(jax.tree.map(np.asarray, jc.params),
                                  jc.model_config),
                     str(model_dir / "model.safetensors"))
    return corpus


def test_port_train_cli_matches_jax_cli(train_corpus, tmp_path):
    import main as jax_main
    from safetensors.numpy import load_file

    from ts_asr_whisper_tpu.models.convert import hf_to_params
    from ts_asr_whisper_tpu_torch.models.convert import state_dict_from_jax

    jax_out, port_out = tmp_path / "jax", tmp_path / "port"
    jax_main.main(_train_overrides(train_corpus, jax_out))
    proc = subprocess.run(
        [sys.executable, "-m", "ts_asr_whisper_tpu_torch", "--device", "cpu",
         *_train_overrides(train_corpus, port_out)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "2",
             "PYTHONPATH": str(REPO), "HOME": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Unfreezing at step 2" in proc.stderr

    jlog, plog = ([json.loads(line) for line in
                   (out / "metrics.jsonl").read_text().splitlines()]
                  for out in (jax_out, port_out))
    assert [r["step"] for r in plog] == [r["step"] for r in jlog] == [1, 2, 3]
    for r, o in zip(jlog, plog):
        for k in ("loss", "dec_loss", "ctc_loss"):
            np.testing.assert_allclose(o[k], r[k], rtol=1e-4, err_msg=k)

    # the port's export loads through the JAX package's hf_to_params, and
    # what it loads is the port's parameters, tensor for tensor
    export = port_out / "hf_export"
    sd = load_file(str(export / "model.safetensors"))
    cfg = json.loads((export / "config.json").read_text())
    jcfg = load_config(_train_overrides(train_corpus, tmp_path / "x"),
                       n_devices=1)
    mc = WhisperContainer(jcfg, seed=0).model_config
    assert {k: cfg[k] for k in MODEL} == {k: getattr(mc, k) for k in MODEL}
    loaded = hf_to_params(sd, mc)
    back = state_dict_from_jax(jax.tree.map(np.asarray, loaded), mc)
    assert set(back) == set(sd)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    assert (export / "generation_config.json").exists()
    assert set(load_file(str(jax_out / "hf_export" / "model.safetensors"))) \
        == set(sd)
