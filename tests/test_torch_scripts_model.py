"""The port's model tools (``ts_asr_whisper_tpu_torch/scripts``:
profile_decode, cuda_kernel_check, probe_train_batch, probe_psi_gather,
export_dicow, smoke_decode, submit_gpu.sh, and the port's own
probe_devicetime) on the CPU at tiny sizes,
against their JAX scripts under ``scripts/`` where those run on the CPU:
the export's tensors and the smoke decode's hypotheses and tcpWER equal the
JAX script's on the same weights; the stage profile prints every stage of
the JAX script; the batch probe reports an out-of-memory error and goes on;
the launcher gives each rank its own RANK / LOCAL_RANK / WORLD_SIZE; and no
device tool runs without a GPU unless ``--device cpu`` asks for the CPU."""

import argparse
import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import torch_parity_utils  # noqa: F401  (caps torch's threads)
from ts_asr_whisper_tpu.config import load_config as jax_load_config
from ts_asr_whisper_tpu.models.containers import \
    WhisperContainer as JaxContainer
from ts_asr_whisper_tpu.models.convert import params_to_hf, save_safetensors
from ts_asr_whisper_tpu.training.checkpoints import \
    export_hf_checkpoint as jax_export
from ts_asr_whisper_tpu_torch.data.synthetic import write_corpus
from ts_asr_whisper_tpu_torch.models.convert import normalize_state_dict
from ts_asr_whisper_tpu_torch.scripts import cuda_kernel_check
from ts_asr_whisper_tpu_torch.scripts import bench_dataloader
from ts_asr_whisper_tpu_torch.scripts import export_dicow
from ts_asr_whisper_tpu_torch.scripts import probe_devicetime
from ts_asr_whisper_tpu_torch.scripts import probe_psi_gather
from ts_asr_whisper_tpu_torch.scripts import probe_train_batch
from ts_asr_whisper_tpu_torch.scripts import profile_decode
from ts_asr_whisper_tpu_torch.scripts import smoke_decode
from ts_asr_whisper_tpu_torch.training import trainer as trainer_mod
from ts_asr_whisper_tpu_torch.training.checkpoints import save_checkpoint

REPO = Path(__file__).resolve().parents[1]
# the verify recipe's 2-layer model
MODEL = {"vocab_size": 2000, "num_mel_bins": 80, "d_model": 32,
         "encoder_layers": 2, "decoder_layers": 2,
         "encoder_attention_heads": 2, "decoder_attention_heads": 2,
         "encoder_ffn_dim": 64, "decoder_ffn_dim": 64,
         "max_source_positions": 1500, "max_target_positions": 64}


def _load_jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _model_dir(tmp: Path) -> Path:
    model_dir = tmp / "model"
    model_dir.mkdir()
    (model_dir / "config.json").write_text(json.dumps(MODEL))
    return model_dir


@pytest.mark.parametrize("tool,argv", [
    (profile_decode, ["--model", "tiny"]),
    (probe_train_batch, ["--model", "tiny"]),
    (smoke_decode, ["--model-dir", "m", "--cutset", "c", "--output-dir",
                    "o"]),
    (bench_dataloader, ["--device-mel", "--n-cuts", "1"]),
], ids=["profile_decode", "probe_train_batch", "smoke_decode",
        "bench_dataloader"])
def test_device_tools_refuse_to_run_without_a_gpu(tool, argv):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the tool would run on it")
    with pytest.raises(SystemExit, match="--device cpu"):
        tool.main(argv)


@pytest.mark.parametrize("tool", [cuda_kernel_check, probe_psi_gather,
                                  probe_devicetime],
                         ids=["cuda_kernel_check", "probe_psi_gather",
                              "probe_devicetime"])
def test_card_only_tools_exit_2_without_a_gpu(tool, capsys):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the tool would run on it")
    assert (tool.main() if tool is cuda_kernel_check else tool.main([])) == 2
    assert "no CUDA device" in capsys.readouterr().out


def test_profile_decode_prints_every_stage(monkeypatch, capsys):
    timeit = profile_decode.timeit
    # one timed call a stage: the test reads the stages, not the times
    monkeypatch.setattr(profile_decode, "timeit",
                        lambda fn: timeit(fn, iters=1, warmup=0))
    profile_decode.main(["--device", "cpu", "--model", "tiny",
                         "--max-new", "8", "--batch", "2",
                         "--beam-batch", "1"])
    out = capsys.readouterr().out
    # each stage line, and the JAX script's f-string that prints it
    labels = {"mel (batch 2, 90s):": 'f"mel (batch {b}, {n_windows * 30}s):',
              "window slice (batch 2):": 'f"window slice (batch {b}):',
              "encoder (batch 2):": 'f"encoder (batch {b}):',
              "greedy loop 8 tok (b2):":
                  'f"greedy loop {args.max_new} tok (b{b}):',
              "beam-5 loop no-CTC (b1):":
                  'f"beam-{args.beams} loop no-CTC (b{bb}):',
              "beam-5 loop +CTC (b1):":
                  'f"beam-{args.beams} loop +CTC (b{bb}):',
              "rescore share": "(rescore share",
              "longform greedy e2e [host feats]:":
                  'f"longform greedy e2e [{label}]:',
              "longform greedy e2e [device feats]:": '"device feats"',
              "  device-stage estimate:": '"  device-stage estimate:'}
    jax_src = (REPO / "scripts" / "profile_decode.py").read_text()
    for label, jax_fragment in labels.items():
        assert label in out, label
        assert jax_fragment in jax_src, jax_fragment
    # one device reading per stage, and none on the CPU
    assert out.count("device not measured") == 8
    launches = json.loads(out.split("kernel launches: ")[1].splitlines()[0])
    assert set(launches) == {"flash_attn_fwd", "flash_attn_bwd",
                             "ancestry_attn", "psi_gather_dot",
                             "kv_reorder_bhtd", "kv_reorder_tbhd",
                             "adamw_multi", "sq_norm_multi"}


def test_probe_train_batch_reports_oom_and_goes_on(monkeypatch, capsys):
    real = trainer_mod.Trainer.probe_step
    sizes = []

    def probe(self, batch):
        rows = batch["input_features"].shape[0]
        sizes.append(rows)
        if rows == 2:
            raise torch.OutOfMemoryError("CUDA out of memory. Tried to "
                                         "allocate 2.00 GiB")
        return real(self, batch)

    monkeypatch.setattr(trainer_mod.Trainer, "probe_step", probe)
    probe_train_batch.main(["--device", "cpu", "--model", "tiny",
                            "--batches", "2", "1"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert [x["batch"] for x in lines] == [2, 1]
    assert not lines[0]["ok"] and "out of memory" in lines[0]["error"]
    assert lines[1]["ok"] and lines[1]["samples_per_s"] > 0
    # warm-up and timed probes at micro-batch 1 after the failed one
    assert sizes == [2] + [1] * (probe_train_batch.WARMUP
                                 + probe_train_batch.REPS)


def test_probe_train_batch_raises_other_errors(monkeypatch):
    def probe(self, batch):
        raise ValueError("not a memory error")

    monkeypatch.setattr(trainer_mod.Trainer, "probe_step", probe)
    with pytest.raises(ValueError, match="not a memory error"):
        probe_train_batch.main(["--device", "cpu", "--model", "tiny",
                                "--batches", "1"])


def test_export_dicow_matches_the_jax_export(tmp_path, capsys):
    """JAX parameters carried into the port, saved by the port's
    save_checkpoint and exported by the tool, give the tensors and config
    of the JAX package's export_hf_checkpoint of the same parameters."""
    model_dir = _model_dir(tmp_path)
    overrides = [f"model.whisper_model={model_dir}", "model.ctc_weight=0.3"]
    jc = JaxContainer(jax_load_config(overrides, n_devices=1), seed=3)
    params = jax.tree.map(np.asarray, jc.params)
    hf = params_to_hf(params, jc.model_config)
    sd = normalize_state_dict({k: torch.from_numpy(np.array(v))
                               for k, v in hf.items()})
    save_checkpoint(str(tmp_path / "ckpt"), sd, step=5)
    export_dicow.main(["--ckpt", str(tmp_path / "ckpt"), "--out",
                       str(tmp_path / "port"), *overrides])
    assert capsys.readouterr().out.strip() == \
        f"Exported step 5 to {tmp_path / 'port'}"
    jax_export(params, jc.model_config, str(tmp_path / "jax"))
    from safetensors.numpy import load_file

    ref = load_file(str(tmp_path / "jax" / "model.safetensors"))
    out = load_file(str(tmp_path / "port" / "model.safetensors"))
    assert sorted(out) == sorted(ref)
    for k, v in ref.items():
        assert out[k].dtype == v.dtype, k
        np.testing.assert_array_equal(out[k], v, err_msg=k)
    assert json.loads((tmp_path / "port" / "config.json").read_text()) == \
        json.loads((tmp_path / "jax" / "config.json").read_text())


def test_smoke_decode_matches_the_jax_script(tmp_path, capsys):
    cutset = write_corpus(tmp_path / "corpus", durations=(10.0, 7.0), seed=0)
    model_dir = _model_dir(tmp_path)
    argv = ["--model-dir", str(model_dir), "--cutset", str(cutset),
            "--batch", "2", "--max-length", "40", "--dtype", "float32",
            "--text-norm", "null"]
    # weights of the config the tool builds, sharpened so that the decode
    # emits words and timestamps (tests/test_torch_end_to_end.py)
    ns = argparse.Namespace(model_dir=model_dir, cutset=cutset,
                            output_dir=tmp_path / "unused", diar_cutset=None,
                            beam=1, ctc_weight=0.0, length_penalty=1.0,
                            batch=2, max_length=40, dtype="float32",
                            text_norm="null", metrics="tcp_wer")
    jc = JaxContainer(jax_load_config(smoke_decode.build_overrides(ns),
                                      n_devices=1), seed=7)
    params = jax.tree.map(np.asarray, jc.params)
    emb = params["decoder"]["embed_tokens"] * 60
    emb[:32] = 0.0
    emb[127: jc.model_config.eos_token_id] = 0.0
    emb[jc.model_config.timestamp_begin + 100:] = 0.0
    params["decoder"]["embed_tokens"] = emb
    save_safetensors(params_to_hf(params, jc.model_config),
                     str(model_dir / "model.safetensors"))

    ref = _load_jax_script("smoke_decode").main(
        argv + ["--output-dir", str(tmp_path / "jax")])
    out = smoke_decode.main(argv + ["--output-dir", str(tmp_path / "port"),
                                    "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == out
    assert {k: v for k, v in out.items() if k != "output_dir"} == \
        {k: v for k, v in ref.items() if k != "output_dir"}
    assert any(k.endswith("tcp_wer") for k in out)
    launches = json.loads(lines[-2].split("kernel launches: ")[1])
    assert launches["flash_attn_fwd"] == 0   # the CPU takes the plain path
    jax_hyps = sorted((tmp_path / "jax").rglob("tcp_wer_hyp.json"))
    port_hyps = sorted((tmp_path / "port").rglob("tcp_wer_hyp.json"))
    assert [p.relative_to(tmp_path / "jax") for p in jax_hyps] == \
        [p.relative_to(tmp_path / "port") for p in port_hyps]
    assert len(port_hyps) == 2
    words = 0
    for a, b in zip(jax_hyps, port_hyps):
        segs = json.loads(b.read_text())
        assert segs == json.loads(a.read_text())
        words += sum(len(s["words"].split()) for s in segs)
    assert words > 0
    assert list((tmp_path / "port").rglob("all_session_wer.csv"))


def _launch(tmp_path, *args):
    """submit_gpu.sh with PYTHON set to a stub that records its rank's
    environment and arguments instead of running the CLI."""
    script = REPO / "ts_asr_whisper_tpu_torch" / "scripts" / "submit_gpu.sh"
    subprocess.run(["bash", "-n", str(script)], check=True)
    stub = tmp_path / "stub.py"
    stub.write_text(
        "import json, os, sys\n"
        "out = {k: os.environ.get(k) for k in\n"
        "       ('RANK', 'LOCAL_RANK', 'WORLD_SIZE', 'MASTER_ADDR')}\n"
        "out['argv'] = sys.argv[1:]\n"
        f"path = r'{tmp_path}' + f\"/env{{out['RANK']}}.json\"\n"
        "json.dump(out, open(path, 'w'))\n")
    runner = tmp_path / "python_stub.sh"
    runner.write_text(f"#!/bin/sh\nexec {sys.executable} {stub} \"$@\"\n")
    runner.chmod(0o755)
    torchrun = shutil.which("torchrun") or str(
        Path(sys.executable).parent / "torchrun")
    env = dict(os.environ, PYTHON=str(runner), TORCHRUN=torchrun)
    subprocess.run(["bash", str(script), *args], cwd=str(REPO), env=env,
                   check=True, timeout=120, capture_output=True)
    return {p.name: json.loads(p.read_text())
            for p in tmp_path.glob("env*.json")}


def test_submit_gpu_sh_local_procs(tmp_path):
    envs = _launch(tmp_path, "--local-procs", "2", "--",
                   "+train=dicow_v3", "training.output_dir=/tmp/x")
    assert sorted(envs) == ["env0.json", "env1.json"]
    for rank in (0, 1):
        e = envs[f"env{rank}.json"]
        assert e["RANK"] == e["LOCAL_RANK"] == str(rank)
        assert e["WORLD_SIZE"] == "2"
        assert e["argv"] == ["-m", "ts_asr_whisper_tpu_torch",
                             "+train=dicow_v3", "training.output_dir=/tmp/x"]


def test_submit_gpu_sh_one_process(tmp_path):
    env = os.environ.copy()
    for key in ("RANK", "LOCAL_RANK", "WORLD_SIZE"):
        assert key not in env   # the test itself runs outside torchrun
    envs = _launch(tmp_path, "--", "--device", "cpu", "+decode=x")
    assert list(envs) == ["envNone.json"]
    assert envs["envNone.json"]["argv"] == ["-m", "ts_asr_whisper_tpu_torch",
                                            "--device", "cpu", "+decode=x"]
