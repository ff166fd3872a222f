"""The port's training entry points on the CPU, against the JAX CLI where
both can draw the same numbers:

- ``+train=se_dicow`` on the enrollment corpus of tests/test_end_to_end.py
  (external enrollment mixtures): the same logged losses as the JAX CLI, an
  HF export that carries the SCBs (``ca_enrolls``) and that the port's
  SE-DiCoW decode loads back;
- ``+pretrain=turbo``, LoRA and the 'dots' / 'attn' remat policies, and
  ``auto_find_batch_size`` through the port's CLI on a tiny model;
- ``auto_find_batch_size`` in-process, as tests/test_end_to_end.py:289: an
  out-of-memory error on the first attempt halves the micro-batch, doubles
  the accumulation and rebuilds the model from its initial weights; any
  other error is raised."""

import json
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file

import torch_parity_utils  # noqa: F401  (caps torch's threads)
from test_torch_end_to_end import (MODEL, _train_overrides,  # noqa: F401
                                   train_corpus)
from ts_asr_whisper_tpu.config import load_config
from ts_asr_whisper_tpu.models.containers import WhisperContainer
from ts_asr_whisper_tpu.models.convert import params_to_hf, save_safetensors
from ts_asr_whisper_tpu_torch.config import load_config as port_load_config
from ts_asr_whisper_tpu_torch.training.trainer import to_device

REPO = Path(__file__).resolve().parents[1]


def _port_cli(overrides, tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "ts_asr_whisper_tpu_torch", "--device", "cpu",
         *overrides],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "2",
             "PYTHONPATH": str(REPO), "HOME": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc


def _losses(out_dir):
    return [json.loads(line) for line in
            (out_dir / "metrics.jsonl").read_text().splitlines()]


@pytest.fixture(scope="module")
def se_corpus(tmp_path_factory):
    """Two 8 s two-speaker recordings, per-speaker enrollment recordings
    with other recording ids, and a tiny SE-DiCoW model (one SCB, its gate
    opened) whose weights both CLIs load."""
    from test_end_to_end import _cut, _make_recording, _sup, _write_manifest

    tmp = tmp_path_factory.mktemp("torch_se_train")
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
    model_dir = tmp / "model"
    model_dir.mkdir()
    (model_dir / "config.json").write_text(json.dumps(
        {**MODEL, "d_model": 128, "encoder_ffn_dim": 256,
         "decoder_ffn_dim": 256}))
    corpus = {"model": model_dir,
              "train": tmp / "tr_cutset_30s_external_enrollment.jsonl.gz",
              "enroll": tmp / "enroll_cutset.jsonl.gz"}
    jc = WhisperContainer(load_config(_se_overrides(corpus, tmp / "x"),
                                      n_devices=1), seed=7)
    params = jax.tree.map(np.asarray, jc.params)
    params["encoder"]["ca_enrolls"]["gate"] = np.full_like(
        params["encoder"]["ca_enrolls"]["gate"], 0.8)
    save_safetensors(params_to_hf(params, jc.model_config),
                     str(model_dir / "model.safetensors"))
    return corpus


def _se_overrides(corpus, out_dir):
    """+train=se_dicow on the tiny model: one SCB, the recipe's env-var
    paths and dataset weights replaced, no other speaker mixed into an
    enrollment (the mixture is then the speaker's longest enrollment cut,
    whatever the RNG), one preheat micro-batch, fp32, no augmentation."""
    return ["+train=se_dicow", f"model.whisper_model={corpus['model']}",
            "model.reinit_encoder_from=null", "model.scb_layers=1",
            "model.dtype=float32", f"data.train_cutsets=[{corpus['train']}]",
            "data.dev_cutsets=[]", "data.eval_cutsets=[]",
            f"data.enrollment_cutsets=[{corpus['enroll']}]",
            "data.number_of_mixed_speakers=0", "data.dataset_weights=null",
            "data.train_text_norm=null", "aug.musan_root=null",
            "aug.stno_gaussian_noise_prob=0.0",
            "aug.stno_segment_augment_prob=0.0", "aug.spec_aug_prob=0.0",
            "training.overall_batch_size=0",
            "training.per_device_train_batch_size=2", "training.max_steps=3",
            "training.use_fddt_only_n_steps=1", "training.warmup_steps=0",
            "training.eval_strategy=no", "training.save_strategy=no",
            "training.logging_steps=1", "training.dataloader_num_workers=1",
            "training.mesh_shape=[1]", f"training.output_dir={out_dir}"]


def test_port_se_dicow_train_cli_matches_jax_cli(se_corpus, tmp_path):
    import main as jax_main

    from ts_asr_whisper_tpu_torch.decode import DecodeRunner

    jax_out, port_out = tmp_path / "jax", tmp_path / "port"
    jax_main.main(_se_overrides(se_corpus, jax_out))
    proc = _port_cli(_se_overrides(se_corpus, port_out), tmp_path)
    assert "Unfreezing at step 1" in proc.stderr
    jlog, plog = _losses(jax_out), _losses(port_out)
    assert [r["step"] for r in plog] == [r["step"] for r in jlog] == [1, 2, 3]
    for r, o in zip(jlog, plog):
        for k in ("loss", "dec_loss", "ctc_loss"):
            np.testing.assert_allclose(o[k], r[k], rtol=1e-4, err_msg=k)

    # the export carries the SCBs and loads into the SE-DiCoW decode
    export = port_out / "hf_export"
    sd = load_file(str(export / "model.safetensors"))
    assert set(sd) == set(load_file(str(jax_out / "hf_export"
                                        / "model.safetensors")))
    scb = {k for k in sd if ".ca_enrolls.0." in k}
    assert scb and "model.encoder.ca_enrolls.0.cae.cross_gate.gate" in scb
    start = load_file(str(se_corpus["model"] / "model.safetensors"))
    assert any(not np.array_equal(sd[k], start[k]) for k in scb)
    cfg = port_load_config([
        "+decode=se_dicow_greedy", f"model.whisper_model={export}",
        "model.scb_layers=1", "model.ctc_weight=0.3", "model.dtype=float32",
        "data.train_cutsets=[]", "data.dev_cutsets=[]",
        f"data.eval_cutsets=[{se_corpus['train']}]",
        f"data.enrollment_cutsets=[{se_corpus['enroll']}]",
        "data.number_of_mixed_speakers=0", "data.eval_text_norm=null",
        "training.generation_max_length=20",
        "training.per_device_eval_batch_size=2",
        "training.save_visualizations=false",
        f"training.output_dir={tmp_path / 'decode'}"])
    runner = DecodeRunner(cfg, torch.device("cpu"))
    loaded = runner.container.model.state_dict()
    for k in scb:
        np.testing.assert_array_equal(loaded[k].numpy(), sd[k], err_msg=k)
    metrics = runner.run()
    key = "eval_tr_cutset_30s_external_enrollment_tcp_wer"
    assert np.isfinite(metrics[key])


def test_port_cli_pretrains_turbo_recipe(tmp_path):
    """+pretrain=turbo on a tiny model dir: three steps, the export and a
    dev WER through the CLI."""
    from ts_asr_whisper_tpu_torch.data.synthetic import write_corpus

    train = write_corpus(tmp_path / "train", durations=(30.0,), seed=1)
    dev = write_corpus(tmp_path / "dev", durations=(40.0,), seed=2)
    model_dir = tmp_path / "model"
    model_dir.mkdir()
    (model_dir / "config.json").write_text(json.dumps(MODEL))
    out = tmp_path / "out"
    proc = _port_cli([
        "+pretrain=turbo", f"model.whisper_model={model_dir}",
        "model.dtype=float32", "model.additional_self_attention_layer=true",
        f"data.train_cutsets=[{train}]", f"data.dev_cutsets=[{dev}]",
        "data.dataset_weights=null", "training.max_steps=3",
        "training.per_device_train_batch_size=2",
        "training.per_device_eval_batch_size=2", "training.logging_steps=1",
        "training.dataloader_num_workers=1", f"training.output_dir={out}"],
        tmp_path)
    assert re.findall(r"pretrain step (\d+) loss", proc.stderr) == \
        ["1", "2", "3"]
    assert "eval_eval_cutset_wer" in proc.stderr.splitlines()[-1]
    sd = load_file(str(out / "hf_export" / "model.safetensors"))
    assert "model.encoder.additional_self_attention_layer.q_proj.weight" \
        in sd and not any("fddt" in k for k in sd)


@pytest.fixture(scope="module")
def full_remat_run(train_corpus, tmp_path_factory):  # noqa: F811
    """The fine-tune's CLI under 'full' checkpointing without LoRA."""
    tmp = tmp_path_factory.mktemp("full_remat")
    _port_cli(_train_overrides(train_corpus, tmp / "out")
              + ["training.gradient_checkpointing=true"], tmp)
    return tmp / "out"


@pytest.mark.parametrize("extra", [
    ["training.use_lora=true", "training.remat_policy=dots"],
    ["training.remat_policy=attn", "training.auto_find_batch_size=true"]])
def test_port_cli_trains_with_lora_remat_and_auto_batch(
        train_corpus, full_remat_run, tmp_path, extra):  # noqa: F811
    """The fine-tune's CLI with gradient checkpointing under the 'dots' or
    'attn' policy, LoRA and auto_find_batch_size: the logged losses of
    'full' checkpointing without LoRA (for the first step only with LoRA,
    whose B is 0 then), an export without adapters."""
    out = tmp_path / "run"
    _port_cli(_train_overrides(train_corpus, out)
              + ["training.gradient_checkpointing=true", *extra], tmp_path)
    ref, got = _losses(full_remat_run), _losses(out)
    assert [r["step"] for r in got] == [1, 2, 3]
    np.testing.assert_allclose(got[0]["loss"], ref[0]["loss"], rtol=1e-6)
    if "training.use_lora=true" not in extra:
        for r, o in zip(ref, got):
            assert o["loss"] == r["loss"]
    sd = load_file(str(out / "hf_export" / "model.safetensors"))
    assert not any("lora" in k for k in sd)
    assert set(sd) == set(load_file(str(full_remat_run / "hf_export"
                                        / "model.safetensors")))


def _model_trainer(corpus, out_dir, *extra):
    from ts_asr_whisper_tpu_torch.train import ModelTrainer

    cfg = port_load_config(_train_overrides(corpus, out_dir) + list(extra))
    return cfg, ModelTrainer(cfg, torch.device("cpu"))


@pytest.mark.parametrize("error", [
    torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2 GiB"),
    RuntimeError("RESOURCE_EXHAUSTED: Out of memory while trying to "
                 "allocate")])
def test_auto_find_batch_size_halves_on_oom(train_corpus, tmp_path,
                                            monkeypatch, error):
    """The first attempt trains one micro-batch, then runs out of memory:
    the retry runs at micro-batch 1 and accumulation 2 from the initial
    weights, and ends where a run started at those settings ends."""
    from ts_asr_whisper_tpu_torch import train as train_mod

    calls = {"n": 0}
    orig = train_mod.Trainer.train

    def flaky(self, it):
        calls["n"] += 1
        if calls["n"] == 1:
            self.train_step(to_device(next(it), torch.device("cpu")))
            raise error
        return orig(self, it)

    ref_cfg, ref = _model_trainer(
        train_corpus, tmp_path / "ref",
        "training.per_device_train_batch_size=1",
        "training.gradient_accumulation_steps=2")
    ref.train()
    monkeypatch.setattr(train_mod.Trainer, "train", flaky)
    cfg, mt = _model_trainer(train_corpus, tmp_path / "oom",
                             "training.auto_find_batch_size=true")
    assert cfg.training.per_device_train_batch_size == 2
    mt.train()
    assert calls["n"] == 2
    assert cfg.training.per_device_train_batch_size == 1
    assert cfg.training.gradient_accumulation_steps == 2
    for k, v in ref.model.state_dict().items():
        assert torch.equal(mt.model.state_dict()[k], v), k


@pytest.mark.parametrize("auto", [False, True])
def test_other_errors_and_oom_without_the_option_are_raised(
        train_corpus, tmp_path, monkeypatch, auto):
    from ts_asr_whisper_tpu_torch import train as train_mod

    _, mt = _model_trainer(train_corpus, tmp_path / "x",
                           f"training.auto_find_batch_size={auto}")
    error = ValueError("bad batch") if auto else torch.OutOfMemoryError(
        "CUDA out of memory")
    calls = []

    def failing(self, it):
        calls.append(1)
        raise error

    monkeypatch.setattr(train_mod.Trainer, "train", failing)
    with pytest.raises(type(error)):
        mt.train()
    assert len(calls) == 1
    assert mt.cfg.training.per_device_train_batch_size == 2
