"""The port's decode CLI (``python -m ts_asr_whisper_tpu_torch``) against the
JAX CLI (``main.main``) on the verify recipe's synthetic corpus and the same
safetensors weights: identical tcpWER hypothesis files and equal tcp_wer,
for long-form greedy decode and for beam-5 joint-CTC decode
(``+decode=dicow_v3_beam_joint``, with the CTC head in the weights)."""

import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

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


def _make_corpus(tmp, overrides):
    manifest = write_corpus(tmp, durations=(10.0, 7.0), seed=0)
    model_dir = tmp / "model"
    model_dir.mkdir()
    (model_dir / "config.json").write_text(json.dumps(MODEL))
    # the weights the JAX CLI builds for this config, sharpened so that the
    # decode emits text tokens and timestamps instead of all deletions
    jcfg = load_config(overrides({"eval": manifest, "model": model_dir},
                                 tmp / "unused"), n_devices=1)
    jc = WhisperContainer(jcfg, seed=7)
    params = jax.tree.map(np.asarray, jc.params)
    emb = params["decoder"]["embed_tokens"] * 60
    ts_begin = jc.model_config.timestamp_begin
    emb[:32] = 0.0                                 # control bytes
    emb[127: jc.model_config.eos_token_id] = 0.0  # non-ASCII, unused ids
    emb[ts_begin + 100:] = 0.0                     # timestamps past 2 s
    params["decoder"]["embed_tokens"] = emb
    save_safetensors(params_to_hf(params, jc.model_config),
                     str(model_dir / "model.safetensors"))
    return {"eval": manifest, "model": model_dir, "tmp": tmp}


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


def test_port_cli_matches_jax_cli(corpus, tmp_path):
    _check_cli(corpus, tmp_path, _overrides)


def test_port_beam_joint_cli_matches_jax_cli(corpus_ctc, tmp_path):
    _check_cli(corpus_ctc, tmp_path, _beam_joint_overrides)


def _check_cli(corpus, tmp_path, overrides):
    import main as jax_main

    jax_out, port_out = tmp_path / "jax", tmp_path / "port"
    ref = jax_main.main(overrides(corpus, jax_out))
    proc = subprocess.run(
        [sys.executable, "-m", "ts_asr_whisper_tpu_torch",
         *overrides(corpus, port_out)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "2",
             "PYTHONPATH": str(REPO), "HOME": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "final metrics" in proc.stderr

    name = "eval_cutset"
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
