"""The port's checkpoints and the training entry point's callbacks:
``save_checkpoint``/``restore_checkpoint`` in the JAX package's
``step_<n>``/``latest`` layout with pruning, the HF export against the JAX
package's ``export_hf_checkpoint`` on the same weights, and a fine-tune
through ``ModelTrainer`` with dev evals, step checkpoints, the best model
reloaded at the end, the export and the final test eval (CPU)."""

import json

import jax
import numpy as np
import pytest
import torch

import torch_parity_utils as U
from ts_asr_whisper_tpu.training.checkpoints import \
    export_hf_checkpoint as jax_export
from ts_asr_whisper_tpu_torch import train as T
from ts_asr_whisper_tpu_torch.config import load_config
from ts_asr_whisper_tpu_torch.data.synthetic import write_corpus
from ts_asr_whisper_tpu_torch.training import checkpoints as C


def test_save_restore_layout_and_pruning(tmp_path):
    _, _, _, model = U.make_pair(seed=0)
    params = model.state_dict()
    opt = {"count": 3, "mu": [torch.ones(2, 3)], "nested": {"x": 1.5}}
    for step in (2, 4, 6):
        path = C.save_checkpoint(str(tmp_path / "ckpt"), params,
                                 opt_state=opt if step == 6 else None,
                                 step=step, keep=2)
        assert path.endswith(f"step_{step}")
    steps = sorted(p.name for p in (tmp_path / "ckpt").glob("step_*"))
    assert steps == ["step_4", "step_6"]
    assert (tmp_path / "ckpt" / "latest").read_text() == "6"
    state, step = C.restore_checkpoint(str(tmp_path / "ckpt"))
    assert step == 6 and state["step"] == 6
    assert state["opt_state"]["count"] == 3
    torch.testing.assert_close(state["opt_state"]["mu"][0], torch.ones(2, 3))
    for k, v in params.items():
        assert torch.equal(state["params"][k], v), k
    state, step = C.restore_checkpoint(str(tmp_path / "ckpt"), step=4)
    assert step == 4 and "opt_state" not in state


def test_hf_export_matches_the_jax_export(tmp_path):
    jcfg, params, tcfg, model = U.make_pair(seed=1)
    gen = {"max_length": 40, "ctc_weight": 0.3}
    jax_export(jax.tree.map(np.asarray, params), jcfg, str(tmp_path / "j"),
               generation_config=gen)
    C.export_hf_checkpoint(model.state_dict(), tcfg, str(tmp_path / "t"),
                           generation_config=gen)
    from safetensors.numpy import load_file

    ref = load_file(str(tmp_path / "j" / "model.safetensors"))
    out = load_file(str(tmp_path / "t" / "model.safetensors"))
    assert sorted(out) == sorted(ref)
    for k, v in ref.items():
        assert out[k].dtype == v.dtype, k
        np.testing.assert_array_equal(out[k], v, err_msg=k)
    for name in ("config.json", "generation_config.json"):
        assert json.loads((tmp_path / "t" / name).read_text()) == \
            json.loads((tmp_path / "j" / name).read_text())


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_callbacks")
    manifest = write_corpus(tmp / "corpus", durations=(30.0, 30.0), seed=2)
    model_dir = tmp / "model"
    model_dir.mkdir()
    (model_dir / "config.json").write_text(json.dumps(
        {"vocab_size": 2000, "num_mel_bins": 80, "d_model": 64,
         "encoder_layers": 1, "decoder_layers": 1,
         "encoder_attention_heads": 1, "decoder_attention_heads": 1,
         "encoder_ffn_dim": 64, "decoder_ffn_dim": 64,
         "max_source_positions": 1500, "max_target_positions": 448}))
    return {"manifest": manifest, "model": model_dir}


def test_model_trainer_runs_its_callbacks(corpus, tmp_path, monkeypatch):
    m = corpus["manifest"]
    cfg = load_config([
        f"model.whisper_model={corpus['model']}",  # bf16: evals on a copy
        f"data.train_cutsets=[{m}]", f"data.dev_cutsets=[{m}]",
        f"data.eval_cutsets=[{m}]", "aug.spec_aug_prob=0.0",
        "training.overall_batch_size=0",
        "training.per_device_train_batch_size=2", "training.max_steps=4",
        "training.use_fddt_only_n_epochs=0", "training.warmup_steps=0",
        "training.eval_strategy=steps", "training.eval_steps=2",
        "training.eval_delay=0", "training.save_strategy=steps",
        "training.save_steps=2", "training.save_total_limit=1",
        "training.load_best_model_at_end=true",
        "training.metric_for_best_model=eval_eval_cutset_tcp_wer",
        "training.generation_max_length=20",
        "training.per_device_eval_batch_size=4",
        "training.dataloader_num_workers=1", "training.logging_steps=2",
        f"training.output_dir={tmp_path}"])
    mt = T.ModelTrainer(cfg, torch.device("cpu"))
    loaded = []
    restore = C.restore_checkpoint

    def spy(directory, *a, **kw):
        loaded.append(directory)
        return restore(directory, *a, **kw)

    monkeypatch.setattr(T, "restore_checkpoint", spy)
    metrics = mt.train()
    # dev evals at steps 2 and 4 on the same data: the first is the best
    for step in (2, 4):
        assert (tmp_path / "dev_eval_cutset" / f"step_{step}"
                / "all_session_wer.csv").exists()
    assert sorted(p.name for p in (tmp_path / "ckpt").glob("step_*")) == \
        ["step_4"]
    assert (tmp_path / "ckpt_best" / "latest").read_text() == "2"
    assert loaded == [str(tmp_path / "ckpt_best")]
    best, _ = C.restore_checkpoint(str(tmp_path / "ckpt_best"))
    for k, v in mt.model.state_dict().items():  # the best model came back
        assert torch.equal(v, best["params"][k]), k
    assert (tmp_path / "hf_export" / "model.safetensors").exists()
    assert (tmp_path / "test_eval_cutset" / "step_4"
            / "all_session_wer.csv").exists()
    assert "eval_eval_cutset_tcp_wer" in metrics
    logs = [json.loads(line) for line in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in logs if "loss" in r] == [2, 4]
    assert [r["step"] for r in logs
            if "eval_eval_cutset_tcp_wer" in r] == [2, 4]
    # the training weights stayed fp32 through the bf16 dev evals
    assert all(p.dtype == torch.float32 for p in mt.model.parameters())
